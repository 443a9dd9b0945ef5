"""PyTorch port, the demo entry points (stllm_tpu_torch/demo_core.py, demo.py,
demo_web.py, demo_gradio.py) against the JAX package's: the port's chat
comes from its ``demo_core.build_chat`` on config/tiny_debug.yaml, the JAX
Chat from the same config, both on the same weights (the port's init with
numpy noise on every leaf, through load_jax_params), and every token id
gets a word of its own in both toy tokenizers, so equal answers mean equal
tokens. The gradio handlers and the web handler (plain, through an
AnswerService, with PrefixSessions) on 127.0.0.1 answer as JAX's do, token
for token; ``demo.main`` runs with --cpu."""

import argparse
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

import demo_web as jweb
from stllm_tpu import demo_core as jcore
from stllm_tpu_torch import demo as tdemo
from stllm_tpu_torch import demo_core as tcore
from stllm_tpu_torch import demo_gradio as tgradio
from stllm_tpu_torch import demo_web as tweb
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.serving import AnswerService, ContinuousBatcher

CFG = "config/tiny_debug.yaml"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _name_every_token(chat):
    tok = chat.llama_tokenizer
    tok.rev.update({i: f"w{i}" for i in range(tok.vocab_size) if i not in tok.rev})


@pytest.fixture(scope="module")
def chats():
    """The port's chat from its build_chat, and a JAX Chat on the same
    config, tokenizers and weights: the port's init with numpy noise on
    every leaf (its zero-init leaves then count too), as JAX arrays,
    converted back into the port's chat."""
    import jax
    import jax.numpy as jnp

    from stllm_tpu.common.config import Config as JConfig
    from stllm_tpu.conversation import Chat as JChat
    from stllm_tpu.models import zoo as jzoo

    tchat = tcore.build_chat(CFG, device="cpu")
    assert tchat.device == torch.device("cpu") and tchat.cfg.video_input == "residual"
    jcfg = jzoo.build_stllm_config(JConfig(CFG).model_cfg)
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy() + (rng.standard_normal(tuple(t.shape)) * 0.02
                                           ).astype(np.float32)), tchat.params)
    tchat.params = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jchat = JChat(jparams, jcfg, jzoo.ToyHashTokenizer(jcfg.llama.vocab_size),
                  qformer_tokenizer=jzoo.ToyHashTokenizer(jcfg.qformer.vocab_size, reserve=2),
                  image_size=tchat.transform.image_size)
    for c in (jchat, tchat):
        _name_every_token(c)
    return jchat, tchat


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("vids")
    rng = np.random.default_rng(0)
    out = {}
    for name in ("a", "b"):
        path = str(root / f"{name}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (28, 28))
        for _ in range(12):
            vw.write(rng.integers(0, 256, (28, 28, 3), dtype=np.uint8))
        vw.release()
        out[name] = path
    return out


def test_gradio_handlers_answer_as_jax(chats, videos):
    jchat, tchat = chats
    assert tcore.gradio_upload(None, 4) == jcore.gradio_upload(None, 4)
    got = tcore.gradio_ask(tchat, "what?", 1, 1.0, [], None)
    assert got == jcore.gradio_ask(jchat, "what?", 1, 1.0, [], None)
    answers = {}
    for name, core, chat in (("jax", jcore, jchat), ("port", tcore, tchat)):
        state, status = core.gradio_upload(videos["a"], 4)
        assert state["num_segments"] == 4 and "ask" in status
        chatbot = []
        for question in ("What is shown?", "And now?"):
            chatbot, state = core.gradio_ask(chat, question, 1, 1.0, chatbot, state,
                                             max_new_tokens=5)
            # each question re-encodes the video: one embedding, one Q/A pair
            assert len(state["img_list"]) == 1 and len(state["conv"].messages) == 2
        answers[name] = chatbot
    assert answers["port"] == answers["jax"]
    assert all(a and "<unk>" not in a for _, a in answers["port"])


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post(port, path, data, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=headers)
    try:
        return json.loads(urllib.request.urlopen(req, timeout=300).read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _session(port, videos, questions):
    """Two sessions, two greedy turns each, asked in turn; the answers."""
    sids = {n: _post(port, "/api/upload?segments=4", open(videos[n], "rb").read(),
                     {"X-Filename": f"{n}.mp4"})["session"] for n in ("a", "b")}
    out = []
    for q in questions:
        for n in ("a", "b"):
            body = {"session": sids[n], "question": q, "temperature": 0.0, "max_new_tokens": 5}
            out.append(_post(port, "/api/ask", json.dumps(body).encode(),
                             {"Content-Type": "application/json"})["answer"])
    return out, sids


def test_web_demo_answers_as_jax(chats, videos):
    jchat, tchat = chats
    questions = ("What happens?", "Why?")
    servers = [_serve(jweb.make_handler(jchat))]
    try:
        want, _ = _session(servers[0].server_address[1], videos, questions)
        service = AnswerService(ContinuousBatcher(tchat.params["llama"], tchat.cfg.llama, slots=2,
                                                  max_len=256))
        try:
            for kw in ({}, {"service": service}, {"prefix_kv": 2}):
                servers.append(_serve(tweb.make_handler(tchat, **kw)))
                port = servers[-1].server_address[1]
                got, sids = _session(port, videos, questions)
                assert got == want, kw
                page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read()
                assert b"Upload video" in page and b"/api/ask" in page
                bad = _post(port, "/api/ask", json.dumps({"session": "nope",
                                                          "question": "?"}).encode(), {})
                assert "error" in bad
                ok = _post(port, "/api/reset", json.dumps({"session": sids["a"]}).encode(), {})
                assert ok == {"ok": True}
        finally:
            service.close()
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
    assert all(a and "<unk>" not in a for a in want)
    with pytest.raises(ValueError):
        tweb.make_handler(tchat, service=object(), prefix_kv=1)


def test_demo_main_and_entry_points(videos, tmp_path, monkeypatch, capsys):
    answer = tdemo.main(["--cfg-path", CFG, "--cpu", "--video-path", videos["b"],
                         "--num-frames", "4", "--num-beams", "2", "--max-new-tokens", "3"])
    assert isinstance(answer, str) and capsys.readouterr().out.strip().endswith(answer)
    args = tweb.parse_args(["--cfg-path", CFG, "--cpu", "--prefix-kv", "2"])
    assert args.prefix_kv == 2 and args.serve_slots == 0
    assert isinstance(tweb.build_chat(argparse.Namespace(cfg_path=CFG, ckpt_path=None,
                                                         options=None, cpu=True)).params, dict)
    with pytest.raises(SystemExit, match="gradio"):
        tgradio.main(["--cfg-path", CFG, "--cpu"])
    ckpt = tmp_path / "weights.pth"
    ckpt.write_bytes(b"")
    with pytest.raises(NotImplementedError):
        tcore.build_chat(CFG, ckpt_path=str(ckpt), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.build_chat(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdemo.main(["--cfg-path", CFG, "--video-path", videos["b"]])
