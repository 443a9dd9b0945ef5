"""The port's parameter trees -> the reference's state-dict names, the inverse
of ``convert/from_torch.py``: a model trained or built here saved in the
files the reference (and ``STLLM.from_config``) reads.

  - ``eva_vit_state``: eva_vit_g.pth (LAVIS EVA-ViT-g, ``BTAdapter_*`` keys
    where the tree has the branch);
  - ``qformer_state``: the LAVIS Q-Former (``Qformer.bert.*``,
    ``query_tokens``);
  - ``hf_llama_state``: HF LlamaForCausalLM, written as shards by
    ``save_hf_shards``;
  - ``stllm_state``: an ST-LLM checkpoint (``visual_encoder.*``,
    ``ln_vision``, the Q-Former, ``llm_proj``, ``down_proj`` / ``up_proj``,
    ``mvm_decoder``) under an optional wrapper prefix.

Linear weights go back to (out, in); every tensor is a compact CPU copy in
``dtype`` (default: the leaf's own). Dense trees only: int8 and int4 leaves
have no name in the reference's files.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch


def _cpu(x: torch.Tensor, dtype=None, transpose: bool = False) -> torch.Tensor:
    """Transposed and cast on the leaf's own device, then copied to the host."""
    if transpose:
        x = x.T
    if dtype is None or not x.is_floating_point():
        dtype = x.dtype
    x = x.to(dtype).contiguous()
    return torch.empty(x.shape, dtype=dtype).copy_(x)


def _linear(out: Dict, prefix: str, p: Dict, dtype) -> None:
    out[f"{prefix}.weight"] = _cpu(p["w"], dtype, transpose=True)
    if p.get("b") is not None:
        out[f"{prefix}.bias"] = _cpu(p["b"], dtype)


def _norm(out: Dict, prefix: str, p: Dict, dtype) -> None:
    out[f"{prefix}.weight"] = _cpu(p["scale"], dtype)
    if p.get("bias") is not None:
        out[f"{prefix}.bias"] = _cpu(p["bias"], dtype)


def _attn_block(out: Dict, pre: str, block: Dict, dtype) -> None:
    _norm(out, f"{pre}.norm1", block["norm1"], dtype)
    out[f"{pre}.attn.qkv.weight"] = _cpu(block["qkv"]["w"], dtype, transpose=True)
    out[f"{pre}.attn.q_bias"] = _cpu(block["q_bias"], dtype)
    out[f"{pre}.attn.v_bias"] = _cpu(block["v_bias"], dtype)
    _linear(out, f"{pre}.attn.proj", block["proj"], dtype)


def _mlp_block(out: Dict, pre: str, block: Dict, dtype) -> None:
    _norm(out, f"{pre}.norm2", block["norm2"], dtype)
    _linear(out, f"{pre}.mlp.fc1", block["fc1"], dtype)
    _linear(out, f"{pre}.mlp.fc2", block["fc2"], dtype)


def eva_vit_state(vit: Dict, dtype=None) -> Dict[str, torch.Tensor]:
    """A ViT tree (models/vit.py, with a ``btadapter`` subtree where it has
    one) in LAVIS eva_vit_g.pth names. The patch embedding (ph * pw * C, D)
    goes back to the Conv2d weight (D, C, ph, pw)."""
    w = vit["patch_embed"]["w"]
    d = w.shape[1]
    patch = int(round((w.shape[0] // 3) ** 0.5))
    out = {"patch_embed.proj.weight": _cpu(w.reshape(patch, patch, 3, d).permute(3, 2, 0, 1),
                                           dtype),
           "patch_embed.proj.bias": _cpu(vit["patch_embed"]["b"], dtype),
           "cls_token": _cpu(vit["cls_token"], dtype),
           "pos_embed": _cpu(vit["pos_embed"], dtype)}
    for i, block in enumerate(vit["blocks"]):
        _attn_block(out, f"blocks.{i}", block, dtype)
        _mlp_block(out, f"blocks.{i}", block, dtype)
    branch = vit.get("btadapter")
    if branch is not None:
        out["BTAdapter_cls"] = _cpu(branch["cls"], dtype)
        out["BTAdapter_position.weight"] = _cpu(branch["time_embed"], dtype)
        for i, layer in enumerate(branch["temp"]):
            _attn_block(out, f"BTAdapter_T.{i}", layer, dtype)
            _linear(out, f"BTAdapter_T.{i}.temporal_fc", layer["temporal_fc"], dtype)
        for i, layer in enumerate(branch["spatial"]):
            _attn_block(out, f"BTAdapter_S.{i}", layer, dtype)
            _mlp_block(out, f"BTAdapter_S.{i}", layer, dtype)
    return out


def qformer_state(qformer: Dict, dtype=None, prefix: str = "Qformer.bert."
                  ) -> Dict[str, torch.Tensor]:
    """A Q-Former tree (models/qformer.py) in LAVIS names: ``query_tokens``
    at the top, the BERT weights under ``prefix``."""
    out = {"query_tokens": _cpu(qformer["query_tokens"], dtype)}
    emb = qformer["embeddings"]
    for name, key in (("word", "word_embeddings"), ("position", "position_embeddings")):
        if emb.get(name) is not None:
            out[f"{prefix}embeddings.{key}.weight"] = _cpu(emb[name], dtype)
    _norm(out, f"{prefix}embeddings.LayerNorm", emb["norm"], dtype)

    def attn(pre: str, p: Dict) -> None:
        for ours, theirs in (("q", "self.query"), ("k", "self.key"), ("v", "self.value"),
                             ("out", "output.dense")):
            _linear(out, f"{pre}.{theirs}", p[ours], dtype)
        _norm(out, f"{pre}.output.LayerNorm", p["out_norm"], dtype)

    for i, layer in enumerate(qformer["layers"]):
        pre = f"{prefix}encoder.layer.{i}"
        attn(f"{pre}.attention", layer["attention"])
        _linear(out, f"{pre}.intermediate_query.dense", layer["intermediate_query"], dtype)
        _linear(out, f"{pre}.output_query.dense", layer["output_query"]["dense"], dtype)
        _norm(out, f"{pre}.output_query.LayerNorm", layer["output_query"]["norm"], dtype)
        if "crossattention" in layer:
            attn(f"{pre}.crossattention", layer["crossattention"])
        if "intermediate" in layer:
            _linear(out, f"{pre}.intermediate.dense", layer["intermediate"], dtype)
            _linear(out, f"{pre}.output.dense", layer["output"]["dense"], dtype)
            _norm(out, f"{pre}.output.LayerNorm", layer["output"]["norm"], dtype)
    return out


def hf_llama_state(llama: Dict, dtype=None, root: str = "model."
                   ) -> Dict[str, torch.Tensor]:
    """A LLaMA tree (models/llama.py) in HF LlamaForCausalLM names, the
    decoder under ``root`` ("model." as HF saves it, or "")."""
    out = {f"{root}embed_tokens.weight": _cpu(llama["embed_tokens"], dtype)}
    for i, layer in enumerate(llama["layers"]):
        pre = f"{root}layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = _cpu(layer["input_norm"]["scale"], dtype)
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                             ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                             ("down", "mlp.down_proj")):
            _linear(out, f"{pre}.{theirs}", layer[ours], dtype)
        out[f"{pre}.post_attention_layernorm.weight"] = _cpu(layer["post_norm"]["scale"], dtype)
    out[f"{root}norm.weight"] = _cpu(llama["norm"]["scale"], dtype)
    out["lm_head.weight"] = _cpu(llama["lm_head"]["w"], dtype, transpose=True)
    return out


def stllm_state(params: Dict, dtype=None, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The parts of a whole tree (models/stllm.py) that an ST-LLM checkpoint
    holds, each where ``params`` has it: ``visual_encoder.*``,
    ``ln_vision``, the Q-Former, ``llama_proj`` under the reference's name
    ``llm_proj``, the residual module and ``mvm_decoder``; every key behind
    ``prefix`` (e.g. "model.stllm_model.")."""
    out: Dict[str, torch.Tensor] = {}
    if params.get("vit") is not None:
        out.update({f"visual_encoder.{k}": v for k, v in eva_vit_state(params["vit"],
                                                                         dtype).items()})
    if params.get("ln_vision") is not None:
        _norm(out, "ln_vision", params["ln_vision"], dtype)
    if params.get("qformer") is not None:
        out.update(qformer_state(params["qformer"], dtype))
    if params.get("llama_proj") is not None:
        _linear(out, "llm_proj", params["llama_proj"], dtype)
    if params.get("residual") is not None:
        _linear(out, "down_proj", params["residual"]["down"], dtype)
        _linear(out, "up_proj", params["residual"]["up"], dtype)
    if params.get("mvm_decoder") is not None:
        _linear(out, "mvm_decoder.head", params["mvm_decoder"]["head"], dtype)
        _norm(out, "mvm_decoder.norm", params["mvm_decoder"]["norm"], dtype)
    return {prefix + k: v for k, v in out.items()}


def save_hf_shards(state: Dict[str, torch.Tensor], model_dir: str, shards: int = 2) -> list:
    """``state`` as ``pytorch_model-0000k-of-0000n.bin`` files in
    ``model_dir`` (keys in order, split near equal bytes) with the
    ``pytorch_model.bin.index.json`` that HF's ``from_pretrained`` reads
    them by; returns the shard paths."""
    os.makedirs(model_dir, exist_ok=True)
    total = sum(t.numel() * t.element_size() for t in state.values())
    groups, size = [[]], 0
    for k, t in state.items():
        if size >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(k)
        size += t.numel() * t.element_size()
    paths = []
    for i, keys in enumerate(groups):
        paths.append(os.path.join(model_dir, f"pytorch_model-{i + 1:05d}-of-{len(groups):05d}.bin"))
        torch.save({k: state[k] for k in keys}, paths[-1])
    index = {"metadata": {"total_size": total},
             "weight_map": {k: os.path.basename(path) for path, keys in zip(paths, groups)
                            for k in keys}}
    with open(os.path.join(model_dir, "pytorch_model.bin.index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return paths
