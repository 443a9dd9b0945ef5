"""The reference's torch checkpoints -> the port's parameter trees
(stllm_tpu/convert/torch_to_jax.py).

The four families the reference loads:
  1. eva_vit_g.pth (LAVIS EVA-ViT-g, with ``BTAdapter_*`` keys for the
     branch)                                  -> models/vit.py, btadapter.py
  2. instruct_blip_*.pth (Q-Former, query tokens, LAVIS names)
                                              -> models/qformer.py
  3. Vicuna / LLaMA in HF names (sharded .bin or .safetensors)
                                              -> models/llama.py
  4. ST-LLM release checkpoints (``llm_proj`` renamed to ``llama_proj``,
     loaded strict=False)                     -> overlaid on a whole tree

Tensors stay torch tensors from the file on. Each leaf goes to the target
device as the file holds it, then is transposed (linear weights are (out,
in) in the files, (in, out) here), cast and made contiguous on that device,
so a 13.5 GB Vicuna state is never copied on the host. Floating leaves are
cast to the config's dtype; ``overlay_stllm_checkpoint`` keeps ``ln_vision``,
``llama_proj``, ``residual`` and ``mvm_decoder`` in the file's dtype, as the
reference does (``linear`` casts its weight to the input's dtype). Missing
and unexpected keys are logged, as the reference's strict=False loads log
them.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from stllm_tpu_torch.common.device import resolve_device

logger = logging.getLogger(__name__)


class KeyTracker:
    """Tracks which source keys were consumed and reports the leftovers."""

    def __init__(self, state: Mapping[str, Any], name: str):
        self.state = dict(state)
        self.used = set()
        self.missing = []
        self.name = name

    def take(self, key: str, optional: bool = False) -> Optional[torch.Tensor]:
        if key in self.state:
            self.used.add(key)
            return torch.as_tensor(self.state[key])
        if not optional:
            self.missing.append(key)
        return None

    def has(self, key: str) -> bool:
        return key in self.state

    def finish(self) -> Tuple[list, list]:
        unexpected = [k for k in self.state if k not in self.used]
        if self.missing:
            logger.warning("%s: %d missing keys (e.g. %s)", self.name,
                           len(self.missing), self.missing[:5])
        if unexpected:
            logger.info("%s: %d unexpected keys ignored (e.g. %s)", self.name,
                        len(unexpected), unexpected[:5])
        return self.missing, unexpected


def _put(x, dtype, device: torch.device, transpose: bool = False):
    """One leaf onto ``device``: the file's bytes as they are, then the
    transpose, the cast (floating leaves only; ``dtype`` None keeps the
    file's) and the contiguous copy in one pass there."""
    if x is None:
        return None
    x = torch.as_tensor(x).to(device)
    if transpose:
        x = x.T
    if dtype is None or not x.is_floating_point():
        dtype = x.dtype
    return torch.empty(x.shape, dtype=dtype, device=device).copy_(x)


def _linear(tk: KeyTracker, prefix: str, dtype, device, bias: bool = True) -> Dict:
    """torch nn.Linear (out, in) -> {"w": (in, out), "b": (out,)}."""
    p = {"w": _put(tk.take(f"{prefix}.weight"), dtype, device, transpose=True)}
    if bias:
        b = tk.take(f"{prefix}.bias", optional=True)
        if b is not None:
            p["b"] = _put(b, dtype, device)
    return p


def _norm(tk: KeyTracker, prefix: str, dtype, device) -> Dict:
    return {"scale": _put(tk.take(f"{prefix}.weight"), dtype, device),
            "bias": _put(tk.take(f"{prefix}.bias"), dtype, device)}


# ---------------------------------------------------------------------------
# EVA ViT-g
# ---------------------------------------------------------------------------

def convert_eva_vit(state: Mapping[str, Any], cfg, dtype=None, device=None) -> Dict:
    """LAVIS eva_vit_g.pth names -> models/vit.py params on ``device``
    (default: the CUDA card). The patch embedding, Conv2d(3, width, 14,
    stride=14) with weight (width, 3, 14, 14), becomes (14 * 14 * 3, width)
    in the (ph, pw, C) order of ``patchify``; the position embedding is
    resampled to ``cfg``'s grid after the cast."""
    from stllm_tpu_torch.models.vit import interpolate_pos_embed

    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    tk = KeyTracker(state, "eva_vit")
    conv_w = tk.take("patch_embed.proj.weight")       # (D, C, ph, pw)
    d = conv_w.shape[0]
    conv_w = conv_w.to(dev).permute(2, 3, 1, 0).reshape(-1, d)   # (ph * pw * C, D)
    params: Dict = {
        "patch_embed": {"w": _put(conv_w, dtype, dev),
                        "b": _put(tk.take("patch_embed.proj.bias"), dtype, dev)},
        "cls_token": _put(tk.take("cls_token"), dtype, dev),
        "pos_embed": _put(tk.take("pos_embed"), dtype, dev),
        "blocks": [],
    }
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        if not tk.has(f"{pre}.norm1.weight"):
            break
        params["blocks"].append({
            "norm1": _norm(tk, f"{pre}.norm1", dtype, dev),
            "qkv": {"w": _put(tk.take(f"{pre}.attn.qkv.weight"), dtype, dev, transpose=True)},
            "q_bias": _put(tk.take(f"{pre}.attn.q_bias"), dtype, dev),
            "v_bias": _put(tk.take(f"{pre}.attn.v_bias"), dtype, dev),
            "proj": _linear(tk, f"{pre}.attn.proj", dtype, dev),
            "norm2": _norm(tk, f"{pre}.norm2", dtype, dev),
            "fc1": _linear(tk, f"{pre}.mlp.fc1", dtype, dev),
            "fc2": _linear(tk, f"{pre}.mlp.fc2", dtype, dev),
        })
    tk.finish()
    params["pos_embed"] = interpolate_pos_embed(params["pos_embed"], cfg.num_patches)
    return params


def convert_btadapter(state: Mapping[str, Any], cfg, depth: int = 3, dtype=None,
                      device=None) -> Dict:
    """The trunk keys as in ``convert_eva_vit`` plus the branch's
    (BTAdapter_cls, BTAdapter_position, BTAdapter_T.{i}, BTAdapter_S.{i})
    -> models/btadapter.py params."""
    params = convert_eva_vit({k: v for k, v in state.items() if not k.startswith("BTAdapter")},
                             cfg, dtype=dtype, device=device)
    params["btadapter"] = convert_btadapter_branch(
        {k: v for k, v in state.items() if k.startswith("BTAdapter")},
        cfg, depth, dtype=dtype, device=device)
    return params


def convert_btadapter_branch(state: Mapping[str, Any], cfg, depth: int = 3, dtype=None,
                             device=None) -> Dict:
    """Just the BTAdapter_* branch keys (trainable-only checkpoints)."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    tk = KeyTracker(state, "btadapter_branch")

    def qkv_attn(pre: str) -> Dict:
        return {
            "norm1": _norm(tk, f"{pre}.norm1", dtype, dev),
            "qkv": {"w": _put(tk.take(f"{pre}.attn.qkv.weight"), dtype, dev, transpose=True)},
            "q_bias": _put(tk.take(f"{pre}.attn.q_bias"), dtype, dev),
            "v_bias": _put(tk.take(f"{pre}.attn.v_bias"), dtype, dev),
            "proj": _linear(tk, f"{pre}.attn.proj", dtype, dev),
        }

    temp, spatial = [], []
    for i in range(depth):
        t_pre, s_pre = f"BTAdapter_T.{i}", f"BTAdapter_S.{i}"
        temp.append({**qkv_attn(t_pre),
                     "temporal_fc": _linear(tk, f"{t_pre}.temporal_fc", dtype, dev)})
        spatial.append({**qkv_attn(s_pre),
                        "norm2": _norm(tk, f"{s_pre}.norm2", dtype, dev),
                        "fc1": _linear(tk, f"{s_pre}.mlp.fc1", dtype, dev),
                        "fc2": _linear(tk, f"{s_pre}.mlp.fc2", dtype, dev)})
    branch = {
        "cls": _put(tk.take("BTAdapter_cls"), dtype, dev),
        "time_embed": _put(tk.take("BTAdapter_position.weight"), dtype, dev),
        "temp": temp,
        "spatial": spatial,
    }
    tk.finish()
    return branch


# ---------------------------------------------------------------------------
# HF LLaMA / Vicuna
# ---------------------------------------------------------------------------

def convert_hf_llama(state: Mapping[str, Any], cfg, dtype=None, device=None) -> Dict:
    """HF LlamaForCausalLM state dict (``model.``-rooted or bare) ->
    models/llama.py params."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    tk = KeyTracker(state, "llama")

    def pfx(key: str) -> str:
        return key if tk.has(key) else key.removeprefix("model.")

    params: Dict = {
        "embed_tokens": _put(tk.take(pfx("model.embed_tokens.weight")), dtype, dev),
        "norm": {"scale": _put(tk.take(pfx("model.norm.weight")), dtype, dev)},
        "lm_head": {"w": _put(tk.take("lm_head.weight"), dtype, dev, transpose=True)},
        "layers": [],
    }
    for i in range(cfg.num_layers):
        pre_full = f"model.layers.{i}"
        pre = pre_full if tk.has(f"{pre_full}.input_layernorm.weight") else f"layers.{i}"
        if not tk.has(f"{pre}.input_layernorm.weight"):
            break

        def lin(name: str) -> Dict:
            return _linear(tk, f"{pre}.{name}", dtype, dev, bias=False)

        params["layers"].append({
            "input_norm": {"scale": _put(tk.take(f"{pre}.input_layernorm.weight"), dtype, dev)},
            "q": lin("self_attn.q_proj"),
            "k": lin("self_attn.k_proj"),
            "v": lin("self_attn.v_proj"),
            "o": lin("self_attn.o_proj"),
            "post_norm": {"scale": _put(tk.take(f"{pre}.post_attention_layernorm.weight"),
                                        dtype, dev)},
            "gate": lin("mlp.gate_proj"),
            "up": lin("mlp.up_proj"),
            "down": lin("mlp.down_proj"),
        })
    tk.finish()
    return params


# ---------------------------------------------------------------------------
# Q-Former (LAVIS / BLIP-2 BERT names)
# ---------------------------------------------------------------------------

def convert_qformer(state: Mapping[str, Any], cfg, dtype=None, prefix: str = "Qformer.bert.",
                    device=None) -> Dict:
    """BLIP-2 / InstructBLIP Q-Former state dict -> models/qformer.py params:
    query_tokens at the top level, the BERT weights under ``prefix``,
    cross-attention in the layers that have it."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    tk = KeyTracker(state, "qformer")

    def lin(pre: str) -> Dict:
        return _linear(tk, pre, dtype, dev)

    def norm(pre: str) -> Dict:
        return _norm(tk, pre, dtype, dev)

    def attn(pre: str) -> Dict:
        return {"q": lin(f"{pre}.self.query"), "k": lin(f"{pre}.self.key"),
                "v": lin(f"{pre}.self.value"), "out": lin(f"{pre}.output.dense"),
                "out_norm": norm(f"{pre}.output.LayerNorm")}

    params: Dict = {
        "query_tokens": _put(tk.take("query_tokens"), dtype, dev),
        "embeddings": {
            "word": _put(tk.take(f"{prefix}embeddings.word_embeddings.weight", optional=True),
                         dtype, dev),
            "position": _put(tk.take(f"{prefix}embeddings.position_embeddings.weight",
                                     optional=True), dtype, dev),
            "norm": norm(f"{prefix}embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        pre = f"{prefix}encoder.layer.{i}"
        if not tk.has(f"{pre}.attention.self.query.weight"):
            break
        layer = {
            "attention": attn(f"{pre}.attention"),
            "intermediate_query": lin(f"{pre}.intermediate_query.dense"),
            "output_query": {"dense": lin(f"{pre}.output_query.dense"),
                             "norm": norm(f"{pre}.output_query.LayerNorm")},
        }
        if tk.has(f"{pre}.crossattention.self.query.weight"):
            layer["crossattention"] = attn(f"{pre}.crossattention")
        if tk.has(f"{pre}.intermediate.dense.weight"):
            layer["intermediate"] = lin(f"{pre}.intermediate.dense")
            layer["output"] = {"dense": lin(f"{pre}.output.dense"),
                               "norm": norm(f"{pre}.output.LayerNorm")}
        params["layers"].append(layer)
    tk.finish()
    return params


def hf_qformer_to_lavis(state: Mapping[str, Any]) -> Dict[str, Any]:
    """HF (Instruct)BlipQFormerModel names -> the LAVIS names
    ``convert_qformer`` reads (attention.attention -> attention.self,
    embeddings.layernorm -> embeddings.LayerNorm, the Qformer.bert. prefix)."""
    out = {}
    for k, v in state.items():
        nk = k.replace("attention.attention.", "attention.self.")
        nk = nk.replace("crossattention.attention.", "crossattention.self.")
        nk = nk.replace("embeddings.layernorm.", "embeddings.LayerNorm.")
        if nk != "query_tokens":
            nk = "Qformer.bert." + nk
        out[nk] = v
    return out


# ---------------------------------------------------------------------------
# ST-LLM release checkpoints (partial, strict=False)
# ---------------------------------------------------------------------------

def rename_stllm_keys(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's key surgery: llm_proj -> llama_proj."""
    return {k.replace("llm_proj", "llama_proj"): v for k, v in state.items()}


def overlay_stllm_checkpoint(params: Dict, state: Mapping[str, Any], cfg,
                             btadapter_depth: int = 3, device=None) -> Dict:
    """An ST-LLM release or trainer checkpoint laid over ``params``
    (strict=False): the wrapper prefixes ``model.stllm_model.``,
    ``stllm_model.`` and ``model.`` are stripped; ``visual_encoder.*`` gives
    the whole ViT (trunk, and branch where it has ``BTAdapter_*`` keys) or,
    without a patch embedding, only the branch grafted onto the existing
    trunk; then ln_vision, the Q-Former with query_tokens, llama_proj,
    the residual module (down_proj / up_proj) and mvm_decoder."""
    dev = resolve_device(device)
    flat: Dict[str, Any] = {}
    for k, v in rename_stllm_keys(state).items():
        for pre in ("model.stllm_model.", "stllm_model.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        flat[k] = v

    def keep(key: str, transpose: bool = False):
        return _put(flat[key], None, dev, transpose)   # the file's dtype

    out = dict(params)
    vit_state = {k[len("visual_encoder."):]: v for k, v in flat.items()
                 if k.startswith("visual_encoder.")}
    if vit_state:
        has_branch = any(k.startswith("BTAdapter") for k in vit_state)
        if "patch_embed.proj.weight" in vit_state and has_branch:
            out["vit"] = convert_btadapter(vit_state, cfg.vit, depth=btadapter_depth, device=dev)
        elif "patch_embed.proj.weight" in vit_state:
            out["vit"] = convert_eva_vit(vit_state, cfg.vit, device=dev)
        elif has_branch:
            vit = dict(out.get("vit") or {})
            vit["btadapter"] = convert_btadapter_branch(
                {k: v for k, v in vit_state.items() if k.startswith("BTAdapter")},
                cfg.vit, btadapter_depth, device=dev)
            out["vit"] = vit
    if "ln_vision.weight" in flat:
        out["ln_vision"] = {"scale": keep("ln_vision.weight"), "bias": keep("ln_vision.bias")}
    q_state = {k: v for k, v in flat.items() if k.startswith("Qformer.") or k == "query_tokens"}
    if any(k.startswith("Qformer.") for k in q_state):
        out["qformer"] = convert_qformer(q_state, cfg.qformer, device=dev)
    if "llama_proj.weight" in flat:
        out["llama_proj"] = {"w": keep("llama_proj.weight", True), "b": keep("llama_proj.bias")}
    if "down_proj.weight" in flat:
        out["residual"] = {
            "down": {"w": keep("down_proj.weight", True), "b": keep("down_proj.bias")},
            "up": {"w": keep("up_proj.weight", True), "b": keep("up_proj.bias")},
        }
    if "mvm_decoder.head.weight" in flat:
        out["mvm_decoder"] = {
            "head": {"w": keep("mvm_decoder.head.weight", True),
                     "b": keep("mvm_decoder.head.bias")},
            "norm": {"scale": keep("mvm_decoder.norm.weight"),
                     "bias": keep("mvm_decoder.norm.bias")},
        }
    return out


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

# safetensors dtype names (https://github.com/huggingface/safetensors, the
# format's README)
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file as CPU tensors over a private mmap of it: an
    8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets}}, then the raw little-endian bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pth / .bin (torch pickle, read with weights_only; mmap'd where it is
    a zip archive) or a .safetensors file -> a flat dict of CPU tensors; a
    top-level "model" dict is unwrapped."""
    path = str(path)
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=zipfile.is_zipfile(path))
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    return dict(state)


def load_sharded_hf(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every weight shard of an HF directory merged into one dict: the
    ``*.safetensors`` files if there are any, else ``pytorch_model*.bin``,
    each in sorted order."""
    shards = sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))) or sorted(
        glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if not shards:
        raise FileNotFoundError(f"no weight shards in {model_dir}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(load_torch_file(shard))
    return state
