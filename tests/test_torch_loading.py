"""PyTorch port, weight and tokenizer loading in the reference's formats
(stllm_tpu_torch/convert/from_torch.py, models/vit.interpolate_pos_embed,
models/zoo.STLLM._load_weights and the tokenizer loaders,
load_model_and_preprocess, models.model_zoo) against the JAX package
(stllm_tpu/convert/torch_to_jax.py, models/zoo.py).

Every state dict is seeded numpy: a port tree's layout filled with normal
draws, written in the reference's names by convert/to_reference.py. The same
dict, or the same files written here, go through both packages, and the two
trees are compared leaf by leaf: path, shape, dtype and value, exact in fp32
(fp16 files keep some leaves in the file's dtype, in both). The position
embedding resample is held within 1e-5 of jax.image.resize in fp32; logits
of a loaded HF LLaMA within 2e-4 of HF's, encodes within 1e-5 of JAX's."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.convert import torch_to_jax as jcvt
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.models import zoo as jzoo
from stllm_tpu_torch.convert import from_torch as tcvt
from stllm_tpu_torch.convert import to_reference as ref
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.models import zoo as tzoo

CFG = {"arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
       "video_input": "all", "btadapter_depth": 1,
       "vit": {"image_size": 28, "patch_size": 14, "width": 32, "depth": 2, "heads": 2,
               "mlp_hidden": 64, "use_flash": False},
       "qformer": {"hidden": 16, "num_layers": 2, "heads": 2, "intermediate": 32,
                   "encoder_width": 32, "num_query": 4, "vocab_size": 64},
       "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
                 "intermediate": 64, "max_positions": 128}}
ENCODE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**extra):
    d = {**CFG, **extra}
    return jzoo.build_stllm_config(d), tzoo.build_stllm_config(d)


def _random_tree(cfg, seed: int) -> dict:
    """The port's init layout for ``cfg``, every leaf a seeded normal draw."""
    rng = np.random.default_rng(seed)
    tree = tst.init_stllm(torch.Generator().manual_seed(0), cfg)

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, list):
            return [fill(v) for v in x]
        if x is None:
            return None
        return torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32) * 0.1)

    return fill(tree)


def _np(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def assert_same_tree(jtree, ttree, skip=lambda path: False):
    """Same paths; at each, the same None-ness, shape, dtype and values."""
    j, t = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
    for path, a in j.items():
        b = t[path]
        if a is None or b is None:
            assert a is None and b is None, path
            continue
        assert (tuple(b.shape), _dtype(b)) == (np.asarray(a).shape, _dtype(a)), path
        if not skip(path):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", ["model.", ""])
def test_convert_hf_llama_roots(root):
    jcfg, tcfg = _cfgs()
    state = _np(ref.hf_llama_state(_random_tree(tcfg, 1)["llama"], root=root))
    assert_same_tree(jcvt.convert_hf_llama(state, jcfg.llama),
                     tcvt.convert_hf_llama(state, tcfg.llama, device="cpu"))


def _lavis_to_hf(state: dict) -> dict:
    """LAVIS Q-Former names -> HF BlipQFormerModel's (the inverse of
    hf_qformer_to_lavis)."""
    out = {}
    for k, v in state.items():
        k = k.removeprefix("Qformer.bert.")
        k = k.replace("crossattention.self.", "crossattention.attention.")
        k = k.replace(".attention.self.", ".attention.attention.")
        out[k.replace("embeddings.LayerNorm.", "embeddings.layernorm.")] = v
    return out


@pytest.mark.parametrize("freq,text_input", [(1, True), (2, False)])
def test_convert_qformer_through_hf_names(freq, text_input):
    """Cross-attention in every layer, or in layer 0 only; with and without
    the text embeddings and FFN."""
    extra = {"qformer": {**CFG["qformer"], "cross_attention_freq": freq},
             "qformer_text_input": text_input}
    jcfg, tcfg = _cfgs(**extra)
    tree = _random_tree(tcfg, 2)["qformer"]
    assert ("crossattention" in tree["layers"][1]) == (freq == 1)
    hf = _np(_lavis_to_hf(ref.qformer_state(tree)))
    jstate, tstate = jcvt.hf_qformer_to_lavis(hf), tcvt.hf_qformer_to_lavis(hf)
    assert list(jstate) == list(tstate) == list(ref.qformer_state(tree))
    assert_same_tree(jcvt.convert_qformer(jstate, jcfg.qformer),
                     tcvt.convert_qformer(tstate, tcfg.qformer, device="cpu"))


@pytest.mark.parametrize("case", ["eva", "btadapter", "eva_resampled"])
def test_convert_vit(case):
    """The trunk alone, trunk plus branch, and a trunk written at a 4 x 4
    patch grid loaded into a 2 x 2 one (the position embedding resampled)."""
    jcfg, tcfg = _cfgs()
    if case == "eva_resampled":
        big = _cfgs(vit={**CFG["vit"], "image_size": 56})[1]
        state = _np(ref.eva_vit_state(_random_tree(big, 3)["vit"]))
        assert state["pos_embed"].shape[1] == 17
    else:
        state = _np(ref.eva_vit_state(_random_tree(tcfg, 3)["vit"]))
    if case == "btadapter":
        want = jcvt.convert_btadapter(state, jcfg.vit, depth=1)
        got = tcvt.convert_btadapter(state, tcfg.vit, depth=1, device="cpu")
    else:
        state = {k: v for k, v in state.items() if not k.startswith("BTAdapter")}
        want = jcvt.convert_eva_vit(state, jcfg.vit)
        got = tcvt.convert_eva_vit(state, tcfg.vit, device="cpu")
    if case == "eva_resampled":
        assert got["pos_embed"].shape == (1, 5, 32)
        np.testing.assert_allclose(got["pos_embed"].numpy(), np.asarray(want["pos_embed"]),
                                   atol=1e-5, rtol=0)
        assert_same_tree(want, got, skip=lambda p: p == "/pos_embed")
    else:
        assert_same_tree(want, got)


@pytest.mark.parametrize("old,new", [(4, 3), (2, 3)])
def test_interpolate_pos_embed(old, new):
    x = np.random.default_rng(old).standard_normal((1, 1 + old * old, 24)).astype(np.float32)
    want = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(x), new * new))
    got = tvit.interpolate_pos_embed(torch.from_numpy(x), new * new).numpy()
    assert got.shape == want.shape == (1, 1 + new * new, 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    same = torch.from_numpy(x)
    assert tvit.interpolate_pos_embed(same, old * old) is same


OVERLAY_PREFIXES = ["model.stllm_model.", "stllm_model.", "model."]


@pytest.mark.parametrize("prefix", OVERLAY_PREFIXES)
@pytest.mark.parametrize("route", ["trunk_and_branch", "trunk", "branch"])
def test_overlay_stllm_checkpoint(route, prefix):
    """An fp16 ST-LLM checkpoint (every module family, visual_encoder as the
    route has it, behind ``prefix``) over an fp32 tree: the converters cast,
    ln_vision, llama_proj, residual and mvm_decoder stay fp16, in both."""
    jcfg, tcfg = _cfgs(video_input="residual", residual_size=2, mvm_decode=True)
    base = _random_tree(tcfg, 4)
    state = _np(ref.stllm_state(_random_tree(tcfg, 5), torch.float16, prefix=prefix))
    branch = f"{prefix}visual_encoder.BTAdapter"
    if route == "trunk":
        state = {k: v for k, v in state.items() if not k.startswith(branch)}
    elif route == "branch":
        state = {k: v for k, v in state.items()
                 if not k.startswith(f"{prefix}visual_encoder.") or k.startswith(branch)}
    jbase = {k: jax.tree_util.tree_map(lambda t: t.numpy(), v) for k, v in base.items()}
    want = jcvt.overlay_stllm_checkpoint(jbase, state, jcfg, btadapter_depth=1)
    got = tcvt.overlay_stllm_checkpoint(base, state, tcfg, btadapter_depth=1, device="cpu")
    assert_same_tree(want, got)
    assert got["llama_proj"]["w"].dtype == torch.float16
    assert got["vit"]["blocks"][0]["qkv"]["w"].dtype == torch.float32
    assert ("btadapter" in got["vit"]) == (route != "trunk")


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _small_state(dtype=np.float32) -> dict:
    rng = np.random.default_rng(6)
    return {"a.weight": rng.standard_normal((3, 5)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "scalar": np.asarray(1.5, dtype),
            "ids": np.arange(4, dtype=np.int64)}


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_torch_file_pth(tmp_path, wrapped):
    state = {k: torch.from_numpy(v) for k, v in _small_state().items()}
    path = tmp_path / "w.pth"
    torch.save({"model": state, "epoch": 3} if wrapped else state, str(path))
    want, got = jcvt.load_torch_file(str(path)), tcvt.load_torch_file(str(path))
    assert list(want) == list(got) == list(state)
    assert_same_tree(want, got)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_safetensors_reader_matches_safetensors(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    path = tmp_path / "w.safetensors"
    state = {k: torch.from_numpy(v) for k, v in _small_state(dtype).items()}
    state["empty"] = torch.zeros((0, 3), dtype=state["b"].dtype)
    save_file(state, str(path), metadata={"format": "pt"})
    want, got = load_file(str(path)), tcvt.load_torch_file(str(path))
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert_same_tree(jcvt.load_torch_file(str(path)), got)


def test_load_sharded_hf_preference_order_and_empty_dir(tmp_path):
    """*.safetensors wins over pytorch_model*.bin; shards merge in sorted
    order (a key in two shards keeps the later one's value); a directory
    without shards raises FileNotFoundError in both."""
    from safetensors.torch import save_file

    a = {"x": torch.zeros(2), "y": torch.ones(3)}
    b = {"x": torch.full((2,), 2.0), "z": torch.arange(4.0)}
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    torch.save({"bin_only": torch.ones(1)}, str(tmp_path / "pytorch_model.bin"))
    want, got = jcvt.load_sharded_hf(str(tmp_path)), tcvt.load_sharded_hf(str(tmp_path))
    assert sorted(got) == ["x", "y", "z"] and got["x"].tolist() == [2.0, 2.0]
    assert_same_tree(want, got)
    for p in tmp_path.glob("*.safetensors"):
        p.unlink()
    assert_same_tree(jcvt.load_sharded_hf(str(tmp_path)), tcvt.load_sharded_hf(str(tmp_path)))
    empty = tmp_path / "empty"
    empty.mkdir()
    for load in (jcvt.load_sharded_hf, tcvt.load_sharded_hf):
        with pytest.raises(FileNotFoundError):
            load(str(empty))


# ---------------------------------------------------------------------------
# STLLM.from_config (tests/test_checkpoint_load.py's cases through both)
# ---------------------------------------------------------------------------

def test_hf_llama_dir_loading(tmp_path):
    """llama_model pointed at a saved HF LlamaForCausalLM (safetensors):
    JAX's LLaMA tree, and logits within 2e-4 of HF's."""
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    from stllm_tpu_torch.models.llama import llama_forward, lm_head

    hf_cfg = HFConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2, intermediate_size=64,
                      max_position_embeddings=128, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = LlamaForCausalLM(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path / "vicuna"))
    assert list((tmp_path / "vicuna").glob("*.safetensors"))
    cfg = {**CFG, "llama_model": str(tmp_path / "vicuna")}
    jm, tm = jzoo.STLLM.from_config(cfg), tzoo.STLLM.from_config(cfg, device="cpu")
    assert_same_tree(jm.params["llama"], tm.params["llama"])
    ids = np.random.default_rng(0).integers(0, 97, (1, 6))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        hidden, _ = llama_forward(tm.params["llama"], input_ids=torch.from_numpy(ids),
                                  cfg=tm.cfg.llama)
        got = lm_head(tm.params["llama"], hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_stllm_release_checkpoint_loading(tmp_path):
    """A reference-named checkpoint ("model" wrapper, model.stllm_model.
    keys, llm_proj) with every family but the LLaMA, through ckpt: JAX's
    tree outside the LLaMA, and the video encode within 1e-5 of JAX's."""
    extra = dict(video_input="residual", residual_size=2, mvm_decode=True)
    tcfg = _cfgs(**extra)[1]
    state = ref.stllm_state(_random_tree(tcfg, 7), prefix="model.stllm_model.")
    assert "model.stllm_model.llm_proj.weight" in state
    path = tmp_path / "stllm.pth"
    torch.save({"model": state}, str(path))
    cfg = {**CFG, **extra, "ckpt": str(path)}
    jm, tm = jzoo.STLLM.from_config(cfg), tzoo.STLLM.from_config(cfg, device="cpu")
    assert_same_tree({k: v for k, v in jm.params.items() if k != "llama"},
                     {k: v for k, v in tm.params.items() if k != "llama"})
    frames = np.random.default_rng(8).integers(0, 256, (4, 28, 28, 3), dtype=np.uint8)
    want = jst.encode_video_for_inference(jm.params, jnp.asarray(frames), jm.cfg)
    with torch.no_grad():
        got = tst.encode_video_for_inference(tm.params, torch.from_numpy(frames), tm.cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENCODE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """The QA config's four weight paths, at the tiny widths: eva_vit_g.pth
    (trunk and branch), an InstructBLIP-style file under "model" (Q-Former,
    query tokens, ln_vision, llm_proj) that is also the ckpt, and a Vicuna
    directory of two pytorch_model-0000k-of-00002.bin shards."""
    root = tmp_path_factory.mktemp("weights")
    tree = _random_tree(_cfgs()[1], 9)
    torch.save(ref.eva_vit_state(tree["vit"]), str(root / "eva_vit_g.pth"))
    blip = {k: v for k, v in ref.stllm_state(tree).items() if not k.startswith("visual_encoder.")}
    assert {"query_tokens", "ln_vision.weight", "llm_proj.weight"} <= set(blip)
    torch.save({"model": blip}, str(root / "instruct_blip_vicuna7b_trimmed.pth"))
    shards = ref.save_hf_shards(ref.hf_llama_state(tree["llama"]), str(root / "vicuna"), 2)
    assert [p.rsplit("/", 1)[1] for p in shards] == ["pytorch_model-00001-of-00002.bin",
                                                     "pytorch_model-00002-of-00002.bin"]
    return {"vit_model_path": str(root / "eva_vit_g.pth"),
            "q_former_model": str(root / "instruct_blip_vicuna7b_trimmed.pth"),
            "ckpt": str(root / "instruct_blip_vicuna7b_trimmed.pth"),
            "llama_model": str(root / "vicuna"), "tree": tree}


def test_from_config_loads_all_four_paths(weight_files):
    """Every leaf of the whole tree comes from the files, equal to JAX's."""
    paths = {k: v for k, v in weight_files.items() if k != "tree"}
    cfg = {**CFG, **paths}
    jm, tm = jzoo.STLLM.from_config(cfg), tzoo.STLLM.from_config(cfg, seed=1, device="cpu")
    assert_same_tree(jm.params, tm.params)
    assert_same_tree(jax.tree_util.tree_map(lambda t: t.numpy(), weight_files["tree"]),
                     tm.params)
    assert tm.llama_tokenizer is None and tm.qformer_tokenizer is None


def test_lora_and_quant_int8_after_loading(weight_files):
    """lora_r and quant_int8 over a loaded tree: JAX's tree (the int8 codes
    and scales exact; the adapters' A factors come from different
    generators, so shape and dtype only), every 2-D w_q column-major."""
    paths = {k: v for k, v in weight_files.items() if k != "tree"}
    cfg = {**CFG, **paths, "lora_r": 4, "quant_int8": True}
    jm, tm = jzoo.STLLM.from_config(cfg), tzoo.STLLM.from_config(cfg, device="cpu")
    assert_same_tree(jm.params, tm.params, skip=lambda p: p.endswith("_lora/a"))
    w_q = [t for p, t in _leaves(tm.params) if p.endswith("/w_q") and t.dim() == 2]
    assert len(w_q) > 20 and all(t.dtype == torch.int8 and t.stride(0) == 1 for t in w_q)


def test_config_paths_that_do_not_exist_are_skipped(tmp_path):
    """The shipped configs' /path/to/... placeholders and a ckpt that is a
    directory leave the random init; a file that is no checkpoint raises."""
    cfg = {**CFG, "vit_model_path": "/path/to/eva_vit_g.pth", "llama_model": "/path/to/v",
           "q_former_model": str(tmp_path / "missing.pth"), "ckpt": str(tmp_path)}
    plain = tzoo.STLLM.from_config(CFG, device="cpu")
    assert_same_tree(plain.params, tzoo.STLLM.from_config(cfg, device="cpu").params)
    (tmp_path / "x.pth").write_text("not a checkpoint")
    with pytest.raises(pickle.UnpicklingError, match="Weights only load failed"):
        tzoo.STLLM.from_config({**CFG, "ckpt": str(tmp_path / "x.pth")}, device="cpu")


# ---------------------------------------------------------------------------
# tokenizers and the entry points
# ---------------------------------------------------------------------------

def test_bert_tokenizer_from_a_vocab_file(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is", "the", "cat",
             "doing", "?", "##s", "dog"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    jt = jzoo.STLLM._load_bert_tokenizer(str(tmp_path))
    tt = tzoo.STLLM._load_bert_tokenizer(str(tmp_path))
    text = "What is the cat doing? dogs"
    assert tt.encode(text, add_special_tokens=True) == jt.encode(text, add_special_tokens=True)
    assert tt.bos_token == "[DEC]" and tt.bos_token_id == jt.bos_token_id == len(words)
    assert tzoo.STLLM._load_bert_tokenizer(str(tmp_path / "none")) is None


def test_llama_tokenizer_directory(tmp_path):
    """A LLaMA tokenizer directory: both packages load it or both return
    None (the slow tokenizer needs sentencepiece); a missing directory is
    None in both."""
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
         "unk_token": "<unk>"}))
    (tmp_path / "tokenizer.model").write_bytes(b"\x00" * 16)
    jt = jzoo.STLLM._load_llama_tokenizer(str(tmp_path))
    tt = tzoo.STLLM._load_llama_tokenizer(str(tmp_path))
    assert (jt is None) == (tt is None)
    if tt is not None:
        assert tt.encode("a cat") == jt.encode("a cat") and tt.pad_token == jt.pad_token
    assert tzoo.STLLM._load_llama_tokenizer(str(tmp_path / "none")) is None


def test_load_model_and_preprocess_matches_jax():
    overrides = {k: v for k, v in CFG.items() if k not in ("arch", "model_type")}
    jm, jvis = jzoo.load_model_and_preprocess("st_llm_hf", "instructblip_vicuna0",
                                              overrides=overrides)
    tm, tvis = tzoo.load_model_and_preprocess("st_llm_hf", "instructblip_vicuna0",
                                              overrides=overrides, device="cpu")
    assert tm.cfg.vit_model == jm.cfg.vit_model == "eva_clip_g"
    assert tm.model_cfg == jm.model_cfg
    shapes = lambda tree: {p: (tuple(np.shape(x)), _dtype(x))  # noqa: E731
                           for p, x in _leaves(tree) if x is not None}
    assert shapes(tm.params) == shapes(jm.params)
    assert sorted(tvis) == sorted(jvis) == ["eval", "train"]
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert tvis["eval"].device == torch.device("cpu")
    assert tvis["eval"](img).shape == jvis["eval"](img).shape == (224, 224, 3)
    assert tvis["train"].image_size == jvis["train"].image_size


def test_model_zoo_table_matches_jax():
    from stllm_tpu.models import model_zoo as jzoo_table
    from stllm_tpu_torch.models import ModelZoo, model_zoo

    assert isinstance(model_zoo, ModelZoo)
    assert str(model_zoo) == str(jzoo_table)
    assert "st_llm_hf" in str(model_zoo) and "instructblip_vicuna0_btadapter" in str(model_zoo)


def test_no_port_module_imports_safetensors_or_transformers_when_imported():
    """The card's machine need not have either: the port reads .safetensors
    itself and imports transformers inside the tokenizer loaders only."""
    import ast
    from pathlib import Path

    root = Path(tzoo.__file__).resolve().parent.parent
    files = sorted(root.rglob("*.py"))
    assert root / "convert" / "from_torch.py" in files
    top = []
    for f in files:
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.Import):
                top += [(f.name, a.name) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                top.append((f.name, node.module))
    assert not [(f, m) for f, m in top if m.split(".")[0] in ("safetensors", "transformers")]
