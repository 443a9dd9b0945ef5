"""LoRA adapters for the LLaMA q/v projections (stllm_tpu/models/lora.py).

The adapters live inside the layer dict (``q_lora`` / ``v_lora`` beside
``q`` / ``v``, each ``{"a": (d_in, r), "b": (r, d_out), "alpha": 0-d fp32}``)
and ``llama._qkv_proj`` adds ``(h @ a) @ b * (alpha / r)`` to the split
outputs when one is present, over a dense, int8 (``w_q`` / ``w_q16``), int4
(``w4``) or fused ``qkv`` base. PEFT's init: A kaiming-uniform(a=sqrt(5)),
bound sqrt(6 / d_in), B zero, so the adapter starts as the identity. A
quantized base gets bf16 adapters. Dropout is omitted, as in the reference
(its documented divergence).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

TARGETS = ("q", "v")  # the reference's target_modules q_proj / v_proj


def lora_scale(layer_lora: Dict) -> float:
    return float(layer_lora["alpha"]) / layer_lora["a"].shape[1]


def _adapter(gen: torch.Generator, d_in: int, d_out: int, r: int, alpha: float, dtype,
             device) -> Dict:
    bound = (6.0 / d_in) ** 0.5       # kaiming-uniform a=sqrt(5) on (r, d_in)
    a = torch.empty((d_in, r), dtype=torch.float32, device=device)
    a.uniform_(-bound, bound, generator=gen)
    return {"a": a.to(dtype), "b": torch.zeros((r, d_out), dtype=dtype, device=device),
            "alpha": torch.tensor(alpha, dtype=torch.float32, device=device)}


def _fan_in_out(layer: Dict, t: str, hidden: int):
    """(d_in, d_out, adapter dtype) of projection ``t`` over its base."""
    base = layer[t]
    if "w" in base:
        d_in, d_out = base["w"].shape
        return d_in, d_out, base["w"].dtype
    if "w4" in base:
        # int4 rows are K/2, but per-channel storage may be K-pre-padded for
        # the kernel, so the packed shape cannot give the true K: every
        # projection but ``down`` reads the hidden vector, and ``down``'s
        # fan-in is ``up``'s fan-out
        d_out = base["w4"].shape[1]
        if t == "down":
            if "gateup" in layer:
                d_in = layer["gateup"]["w4_scale"].shape[-1] // 2
            else:
                d_in = layer["up"]["w4_scale"].shape[-1]
        else:
            d_in = hidden
        return d_in, d_out, torch.bfloat16
    wq = base.get("w_q", base.get("w_q16"))     # int8 forms keep (K, N)
    return wq.shape[0], wq.shape[1], torch.bfloat16


def add_lora(params: Dict, gen: torch.Generator, r: int, alpha: float = 32.0,
             targets: Sequence[str] = TARGETS) -> Dict:
    """Attach LoRA factors to every LLaMA layer, in a copied tree (the base
    leaves are shared, not copied). ``gen`` draws the A factors on its
    device, layer by layer, target by target."""
    llama = dict(params["llama"])
    hidden = llama["embed_tokens"].shape[1]
    device = llama["embed_tokens"].device
    layers = []
    for layer in llama["layers"]:
        layer = dict(layer)
        for t in targets:
            if t not in layer and t in ("q", "k", "v") and "qkv" in layer:
                # fused serving tree: the adapters still address the split
                # names (applied to the split outputs in _qkv_proj)
                fused = layer["qkv"]
                d_out = fused.get("w4_scale", fused.get("w_scale")).shape[-1] // 3
                layer[f"{t}_lora"] = _adapter(gen, hidden, d_out, r, alpha, torch.bfloat16,
                                              device)
                continue
            d_in, d_out, dtype = _fan_in_out(layer, t, hidden)
            layer[f"{t}_lora"] = _adapter(gen, d_in, d_out, r, alpha, dtype, device)
        layers.append(layer)
    llama["layers"] = layers
    out = dict(params)
    out["llama"] = llama
    return out


def apply_lora(layer: Dict, name: str, h: torch.Tensor, base_out: torch.Tensor) -> torch.Tensor:
    """base_out + (h @ a) @ b * (alpha / r) when the adapter exists; the
    product runs in the promoted dtype of ``h`` and the factors, and the
    scale is cast to the delta's dtype."""
    lora = layer.get(f"{name}_lora")
    if lora is None:
        return base_out
    a, b = lora["a"], lora["b"]
    dt = torch.promote_types(h.dtype, a.dtype)
    scale = lora["alpha"].float() / a.shape[1]
    delta = (h.to(dt) @ a.to(dt)) @ b.to(dt)
    return base_out + delta * scale.to(delta.dtype)


def merge_lora(params: Dict, targets: Sequence[str] = TARGETS) -> Dict:
    """Fold the adapters into the dense base weights and drop them (an
    inference export), in a copied tree."""
    llama = dict(params["llama"])
    layers = []
    for layer in llama["layers"]:
        layer = dict(layer)
        for t in targets:
            lora = layer.pop(f"{t}_lora", None)
            if lora is not None:
                w = layer[t]["w"]
                delta = (lora["a"].float() @ lora["b"].float()) * lora_scale(lora)
                layer[t] = {**layer[t], "w": (w.float() + delta).to(w.dtype)}
        layers.append(layer)
    llama["layers"] = layers
    out = dict(params)
    out["llama"] = llama
    return out


def convert_peft_lora(state, params: Dict, dtype=None) -> Dict:
    """Overlay PEFT ``lora_A`` / ``lora_B`` checkpoint keys
    (base_model.model.model.layers.{i}.self_attn.{q,v}_proj.lora_{A,B}.weight,
    torch (out, in) layout) onto the tree as (in, out) factors, in the base
    weight's dtype unless ``dtype`` is given; a new adapter takes alpha 32."""
    llama = dict(params["llama"])
    layers = [dict(l) for l in llama["layers"]]
    for k, v in state.items():
        if "lora_" not in k:
            continue
        parts = k.split(".")
        i = int(parts[parts.index("layers") + 1])
        proj = [p for p in parts if p.endswith("_proj")][0][0]   # 'q' or 'v'
        ab = "a" if "lora_A" in k else "b"
        w = layers[i][proj]["w"]
        src = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        tgt = layers[i].setdefault(
            f"{proj}_lora", {"alpha": torch.tensor(32.0, device=w.device)})
        tgt[ab] = src.T.contiguous().to(device=w.device, dtype=dtype or w.dtype)
    llama["layers"] = layers
    out = dict(params)
    out["llama"] = llama
    return out
