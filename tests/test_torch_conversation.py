"""PyTorch port, the conversation layer (stllm_tpu_torch/conversation) against
the JAX package's on the tiny model of tests/test_conversation.py: JAX
params converted by load_jax_params, fp32, the same toy word tokenizer.
Prompts and turn merging are compared exactly, the context embeddings
within 1e-5, greedy answers (template and simple mode, where the forced
repetition penalty 1.5 applies), beam answers and PrefixSession turns token
for token."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu import conversation as jconv
from stllm_tpu.models.llama import LlamaConfig as JLlama
from stllm_tpu.models.qformer import QFormerConfig as JQF
from stllm_tpu.models.stllm import STLLMConfig as JST, init_stllm
from stllm_tpu.models.vit import ViTConfig as JViT
from stllm_tpu_torch import conversation as tconv
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.models.llama import LlamaConfig as TLlama
from stllm_tpu_torch.models.qformer import QFormerConfig as TQF
from stllm_tpu_torch.models.stllm import STLLMConfig as TST
from stllm_tpu_torch.models.vit import ViTConfig as TViT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VIT = dict(image_size=28, patch_size=14, width=32, depth=2, heads=2, mlp_hidden=64,
           use_flash=False)
QF = dict(hidden=16, num_layers=2, heads=2, intermediate=32, encoder_width=32, num_query=4,
          vocab_size=64)
LL = dict(vocab_size=4096, hidden=32, num_layers=2, heads=2, intermediate=64,
          max_positions=1024)
JCFG = JST(vit=JViT(dtype=jnp.float32, **VIT), qformer=JQF(dtype=jnp.float32, **QF),
           llama=JLlama(dtype=jnp.float32, **LL), video_input="residual", residual_size=2)
TCFG = TST(vit=TViT(dtype=torch.float32, **VIT), qformer=TQF(dtype=torch.float32, **QF),
           llama=TLlama(dtype=torch.float32, **LL), video_input="residual", residual_size=2)
TEMPLATES = ("CONV_VISION_Vicuna0", "CONV_VIDEO_Vicuna0", "CONV_instructblip_Vicuna0",
             "CONV_VISION_LLama2", "CONV_VIDEO_LLama2")


class ToyTokenizer:
    def __init__(self, vocab=4096):
        self.vocab = vocab
        self.rev = {}

    def encode(self, text, add_special_tokens=False):
        ids = [1] if add_special_tokens else []
        for w in text.split(" "):
            t = 10 + (zlib.crc32(w.encode()) % (self.vocab - 10))
            self.rev[t] = w
            ids.append(t)
        return ids

    def decode(self, ids):
        return " ".join(self.rev.get(int(t), "<unk>") for t in ids if t > 1)


@pytest.fixture(scope="module")
def chats():
    jp = init_stllm(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    # give the zero-init residual adapter and biases values, so they count
    jp = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), jp)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return (jconv.Chat(jp, JCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64),
                       image_size=28),
            tconv.Chat(tp, TCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64),
                       image_size=28))


def _frames(seed, t=4, size=28):
    return np.random.default_rng(seed).integers(0, 256, (t, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", TEMPLATES)
def test_templates_and_prompts_match_jax(name):
    j, t = getattr(jconv, name).copy(), getattr(tconv, name).copy()
    assert t.dict() == j.dict() and t.instruction == j.instruction
    for conv in (j, t):
        conv.append_message(conv.roles[0], "<Video><ImageHere></Video> what is it?")
        conv.append_message(conv.roles[1], "a cat")
        conv.append_message(conv.roles[0], "and then?")
        conv.append_message(conv.roles[1], None)
    assert t.get_prompt() == j.get_prompt()


def test_two_style_copy_and_easydict_match_jax():
    kw = dict(system="SYS", roles=("U: ", "A: "), offset=0, instruction=False, sep="#",
              sep2="&")
    j = jconv.Conversation(messages=[], sep_style=jconv.SeparatorStyle.TWO, **kw)
    t = tconv.Conversation(messages=[], sep_style=tconv.SeparatorStyle.TWO, **kw)
    for conv in (j, t):
        for role, msg in (("U: ", "q1"), ("A: ", "a1"), ("U: ", "q2"), ("A: ", None)):
            conv.append_message(role, msg)
    assert t.get_prompt() == j.get_prompt() == "SYS#U: q1#A: a1&U: q2#A: "
    t.skip_next = True
    clone = t.copy()
    clone.messages[0][1] = "changed"
    assert t.messages[0][1] == "q1" and clone.skip_next is False
    d = tconv.EasyDict(a=1)
    d.b = 2
    assert (d.a, d["b"]) == (1, 2)
    with pytest.raises(AttributeError):
        d.c


def test_ask_merges_like_jax(chats):
    jchat, tchat = chats
    for tag in ("<Video><ImageHere></Video>", "<Img><ImageHere></Img>", "<Frame>x</Frame>",
                "plain text"):
        j, t = jconv.CONV_VIDEO_Vicuna0.copy(), tconv.CONV_VIDEO_Vicuna0.copy()
        for chat, conv in ((jchat, j), (tchat, t)):
            conv.append_message(conv.roles[0], tag)
            chat.ask("describe the video", conv)
            chat.ask("second question", conv)
        assert t.messages == j.messages


def _upload(chat, conv_name, frames, text, pkg):
    conv = getattr(pkg, conv_name).copy()
    img_list = []
    assert chat.upload_video(frames, conv, img_list, text=text) == "Received."
    return conv, img_list


@pytest.mark.parametrize("text", [None, "what is it"])
def test_context_embeddings_match_jax(chats, text):
    """upload_video (with and without Q-Former text), then get_context_emb
    and get_context_emb_sim, within 1e-5."""
    jchat, tchat = chats
    frames = _frames(1)
    out = {}
    for chat, pkg, key in ((jchat, jconv, "j"), (tchat, tconv, "t")):
        conv, imgs = _upload(chat, "CONV_VIDEO_Vicuna0", frames, text, pkg)
        chat.ask("what is it?", conv)
        conv.append_message(conv.roles[1], None)
        out[key] = (imgs[0], chat.get_context_emb(conv, imgs),
                    chat.get_context_emb_sim(conv, imgs),
                    chat.get_context_emb_sim(conv, imgs, system=False))
    for j, t in zip(out["j"], out["t"]):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    v = TCFG.num_video_tokens(4)
    np.testing.assert_array_equal(out["t"][2][:, :v].numpy(), out["t"][0].numpy())


def test_upload_img_and_video_file_match_jax(chats, tmp_path):
    """An image, and an mp4 read through the port's reader (constant
    frames, so both packages' resizes are exact)."""
    import cv2

    jchat, tchat = chats
    path = str(tmp_path / "v.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (40, 48))
    for i in range(20):
        vw.write(np.full((48, 40, 3), 20 + 8 * i, np.uint8))
    vw.release()
    image = _frames(2, t=1, size=40)[0]
    embs = {}
    for chat, pkg in ((jchat, jconv), (tchat, tconv)):
        conv, imgs = pkg.CONV_VISION_Vicuna0.copy(), []
        chat.upload_img(image, conv, imgs)
        chat.upload_video(path, conv, imgs, num_frame=4)
        embs[pkg] = (conv.messages, imgs)
    assert embs[tconv][0] == embs[jconv][0]
    for j, t in zip(embs[jconv][1], embs[tconv][1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("conv_name,extra", [
    ("CONV_VIDEO_Vicuna0", dict()),
    ("CONV_instructblip_Vicuna0", dict()),                  # simple mode: penalty 1.5 forced
    ("CONV_instructblip_Vicuna0", dict(system=False, min_length=3)),
    ("CONV_VIDEO_Vicuna0", dict(repetition_penalty=1.2, max_length=40))])
def test_greedy_answer_matches_jax(chats, conv_name, extra):
    """do_sample=False: the same text, tokens and conversation state."""
    jchat, tchat = chats
    res = {}
    for chat, pkg in ((jchat, jconv), (tchat, tconv)):
        conv, imgs = _upload(chat, conv_name, _frames(3), "q", pkg)
        chat.ask("say something", conv)
        text, tokens = chat.answer(conv, imgs, max_new_tokens=10, do_sample=False, **extra)
        res[pkg] = (text, list(np.asarray(tokens)), conv.messages)
    assert res[tconv] == res[jconv]
    assert 1 <= len(res[tconv][1]) <= 10


def test_sampled_answer_defaults_are_seeded(chats):
    """The reference's defaults (do_sample=True, top_p 0.9) run, and the
    same seed gives the same answer."""
    _, tchat = chats
    outs = []
    for seed in (4, 4, 5):
        conv, imgs = _upload(tchat, "CONV_instructblip_Vicuna0", _frames(4), "q", tconv)
        tchat.ask("what happens?", conv)
        text, tokens = tchat.answer(conv, imgs, max_new_tokens=12, seed=seed)
        assert conv.messages[-1] == [conv.roles[1], text]
        outs.append(list(tokens))
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_unported_answer_paths_raise(chats):
    """Every answer path runs. answer(service=...) through an AnswerService
    gives the JAX Chat's tokens through its own service (greedy, template
    mode), and a request the batcher refuses (beams; the simple prompt's
    forced repetition penalty) falls back to solo generate with the
    tokens answer gives without a service. Beams, the prefix session and
    batched beams: answer(num_beams=2) and two turns through
    answer(kv_session=...) give the JAX Chat's tokens, and answer_batched
    gives each conversation's sequential beam answer."""
    from stllm_tpu.models.generation import PrefixSession as JSession
    from stllm_tpu.serving import AnswerService as JService, ContinuousBatcher as JBatcher
    from stllm_tpu_torch.models.generation import PrefixSession as TSession
    from stllm_tpu_torch.serving import AnswerService as TService, ContinuousBatcher as TBatcher

    jchat, tchat = chats
    served = {}
    for chat, pkg, service, batcher in ((jchat, jconv, JService, JBatcher),
                                        (tchat, tconv, TService, TBatcher)):
        svc = service(batcher(chat.params["llama"], chat.cfg.llama, slots=2, max_len=512,
                              chunk=4))
        try:
            conv, imgs = _upload(chat, "CONV_VIDEO_Vicuna0", _frames(5), None, pkg)
            chat.ask("why?", conv)
            served[pkg] = list(chat.answer(conv, imgs, max_new_tokens=6, do_sample=False,
                                           service=svc)[1])
            if pkg is tconv:
                for kw, name in ((dict(num_beams=2), "CONV_VIDEO_Vicuna0"),
                                 ({}, "CONV_instructblip_Vicuna0")):
                    conv, imgs = _upload(chat, name, _frames(6), "q", pkg)
                    chat.ask("why?", conv)
                    solo_conv = conv.copy()
                    got = chat.answer(conv, imgs, max_new_tokens=5, do_sample=False,
                                      service=svc, **kw)[1]
                    want = chat.answer(solo_conv, imgs, max_new_tokens=5, do_sample=False,
                                       **kw)[1]
                    assert list(got) == list(want)
        finally:
            svc.close()
    assert served[tconv] == served[jconv]

    res = {}
    for chat, pkg, session in ((jchat, jconv, JSession), (tchat, tconv, TSession)):
        out = []
        for conv_name in ("CONV_VIDEO_Vicuna0", "CONV_instructblip_Vicuna0"):
            conv, imgs = _upload(chat, conv_name, _frames(5), "q", pkg)
            chat.ask("why?", conv)
            out.append(list(chat.answer(conv, imgs, max_new_tokens=6, num_beams=2,
                                        do_sample=False)[1]))
        sess = session(chat.params["llama"], chat.cfg.llama, max_len=256)
        conv, imgs = _upload(chat, "CONV_VIDEO_Vicuna0", _frames(6), "q", pkg)
        for q in ("what is happening?", "and then?"):
            chat.ask(q, conv)
            out.append(list(chat.answer(conv, imgs, max_new_tokens=6, do_sample=False,
                                        kv_session=sess)[1]))
        out.append(sess.last_reused)
        res[pkg] = out
    assert res[tconv] == res[jconv]
    assert res[tconv][-1] > 0

    for conv_name in ("CONV_VIDEO_Vicuna0", "CONV_instructblip_Vicuna0"):
        convs, lists = zip(*(_upload(tchat, conv_name, _frames(7 + i), "q", tconv)
                             for i in range(3)))
        for i, c in enumerate(convs):
            tchat.ask(f"what is in clip {i}?", c)
        seq = [tchat.answer(c.copy(), imgs, max_new_tokens=6, num_beams=2, do_sample=False)[0]
               for c, imgs in zip(convs, lists)]
        assert tchat.answer_batched(list(convs), list(lists), max_new_tokens=6,
                                    num_beams=2) == seq
        assert [c.messages[-1][1] for c in convs] == seq
    with pytest.raises(ValueError, match="mixed"):
        tchat.answer_batched([tconv.CONV_VIDEO_Vicuna0.copy(),
                              tconv.CONV_instructblip_Vicuna0.copy()], [[], []])


def test_zoo_chat_and_ensure_tokenizers():
    """STLLM carries no tokenizer until ensure_tokenizers installs the toy
    ones; chat() hands them, the params and the device to Chat."""
    model = tzoo.STLLM.from_config({
        "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
        "video_input": "all", "btadapter_depth": 1,
        "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
        "qformer": {"hidden": 16, "num_layers": 1, "heads": 2, "intermediate": 32,
                    "encoder_width": 32, "num_query": 4, "vocab_size": 64},
        "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 1, "heads": 2,
                  "intermediate": 64}}, seed=0, device="cpu")
    assert model.llama_tokenizer is None and model.qformer_tokenizer is None
    assert tzoo.ensure_tokenizers(model, warn=False) is model
    assert model.llama_tokenizer.vocab_size == 97 and model.qformer_tokenizer.vocab_size == 64
    chat = model.chat(image_size=28)
    assert chat.llama_tokenizer is model.llama_tokenizer and chat.device.type == "cpu"
    conv, imgs = tconv.CONV_VIDEO_Vicuna0.copy(), []
    chat.upload_video(_frames(6, size=36), conv, imgs, text="q")
    chat.ask("what?", conv)
    text, tokens = chat.answer(conv, imgs, max_new_tokens=5, do_sample=False)
    assert isinstance(text, str) and all(0 <= t < 97 for t in tokens)
