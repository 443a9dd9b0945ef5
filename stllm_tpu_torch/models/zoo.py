"""Model zoo: config-driven construction of the full ST-LLM stack
(stllm_tpu/models/zoo.py).

``STLLM.from_config`` builds the config from a YAML model section and
initializes random weights from a seed on the chosen device; ``quant_int8``
converts the tree to W8A8 (dynamic int8, see ``ops/quant.py``) and
``llama: {kv_int8: true}`` gives the LLaMA an int8 KV cache.
``STLLM.trainable_fn`` reads the config's freezing keys for the trainer;
``dtype`` (fp32 or bf16) is the parameters' dtype; ``lora_r > 0`` attaches
LoRA adapters (``models/lora.py``) before any quantization, as the
reference does. Loading checkpoints and tokenizers come with later slices;
a config that names an existing weight file raises rather than run on
random weights, and
``ensure_tokenizers`` installs the toy hash tokenizers that ``STLLM.chat``
then hands to ``Chat``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from stllm_tpu_torch.common.device import resolve_device
from stllm_tpu_torch.common.registry import Registry
from stllm_tpu_torch.models.llama import VICUNA_7B, quantize_llama_params
from stllm_tpu_torch.models.qformer import INSTRUCT_BLIP_QFORMER
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G, quantize_vit_params
from stllm_tpu_torch.ops.quant import quantize_tree_linears
from stllm_tpu_torch.ops.tome import level_kwargs

logger = logging.getLogger(__name__)

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.bfloat16,  # fp16 checkpoints run as bf16, as in the reference
           "fp32": torch.float32, "float32": torch.float32}


def _tuplify(v):
    """YAML lists -> nested tuples, so the frozen configs stay hashable."""
    return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v


def _sub_config(base, overrides: Mapping, dtype) -> Any:
    fields = {f.name for f in dataclasses.fields(base)}
    kw = {k: _tuplify(v) for k, v in (overrides or {}).items() if k in fields}
    return dataclasses.replace(base, dtype=dtype, **kw)


def build_stllm_config(cfg: Mapping) -> STLLMConfig:
    """YAML model section -> STLLMConfig, with the reference's keys and
    defaults (video_input, residual_size, use_mask, mvm_decode,
    qformer_text_input, max_txt_len, end_sym, model_type *_btadapter) and
    the optional size overrides under ``vit:``/``qformer:``/``llama:``."""
    dtype = _DTYPES.get(str(cfg.get("dtype", cfg.get("vit_precision", "bf16"))).lower(),
                        torch.bfloat16)
    model_type = cfg.get("model_type", "instructblip_vicuna0")
    vit_model = cfg.get("vit_model")
    if vit_model is None:
        vit_model = ("eva_btadapter_g" if str(model_type).endswith("_btadapter")
                     else "eva_clip_g")
    qformer_text_input = cfg.get("qformer_text_input", "instructblip" in str(model_type))
    vit_over = dict(cfg.get("vit") or {})
    llama_over = dict(cfg.get("llama") or {})
    level = vit_over.get("merge_level", "")
    if level and level != "auto":
        # a named level expands to its schedules (ops/tome.py MERGE_LEVELS);
        # "auto" stays and resolves per video at the inference entry points
        for k, v in level_kwargs(level).items():
            vit_over.setdefault(k, v)
        vit_over["merge_level"] = ""
    if cfg.get("use_grad_checkpoint", False):
        vit_over.setdefault("remat", True)
        llama_over.setdefault("remat", True)
    return STLLMConfig(
        vit=_sub_config(EVA_VIT_G, vit_over, dtype),
        qformer=_sub_config(INSTRUCT_BLIP_QFORMER, cfg.get("qformer"), dtype),
        llama=_sub_config(VICUNA_7B, llama_over, dtype),
        video_input=cfg.get("video_input", "residual"),
        residual_size=cfg.get("residual_size", 4),
        use_mask=cfg.get("use_mask", False),
        mvm_decode=cfg.get("mvm_decode", False),
        qformer_text_input=qformer_text_input,
        vit_model=vit_model,
        btadapter_depth=cfg.get("btadapter_depth", 3),
        max_txt_len=cfg.get("max_txt_len", 32),
        end_sym=cfg.get("end_sym", "\n"),
    )


_WEIGHT_KEYS = ("vit_model_path", "q_former_model", "llama_model", "ckpt")


@Registry.register_model("st_llm_hf")
class STLLM:
    """Bundled (cfg, params, device). ``llama_tokenizer`` and
    ``qformer_tokenizer`` stay None (no tokenizer loads) until
    ``ensure_tokenizers`` installs toy ones."""

    PRETRAINED_MODEL_CONFIG_DICT = {
        "instructblip_vicuna0": "configs/models/instructblip_vicuna0.yaml",
        "instructblip_vicuna0_btadapter": "configs/models/instructblip_vicuna0_btadapter.yaml",
        "minigpt4_vicuna0": "configs/models/minigpt4_vicuna0.yaml",
        "minigpt4_vicuna0_btadapter": "configs/models/minigpt4_vicuna0_btadapter.yaml",
    }

    def __init__(self, cfg: STLLMConfig, params: Dict, device: torch.device,
                 model_cfg: Optional[Mapping] = None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.model_cfg = dict(model_cfg or {})
        self.llama_tokenizer = None
        self.qformer_tokenizer = None

    @classmethod
    def from_config(cls, model_cfg: Mapping, seed: int = 0, device=None) -> "STLLM":
        """Random init from ``seed`` on ``device`` (default: the CUDA card;
        raises without one). ``lora_r > 0`` adds adapters of that rank
        (``lora_alpha``, default 32) from a generator seeded ``seed + 1``.
        ``quant_int8: true`` converts the ViT with its
        BTAdapter branch, the Q-Former and the LLaMA decoder layers to W8A8,
        dropping each dense weight as it goes; ``llama_proj``, the patch
        embedding, the embeddings, ``lm_head`` and the norms stay dense.
        Static int8 follows from ``btadapter.calibrate_btadapter_scales`` on
        ``params["vit"]``."""
        dev = resolve_device(device)
        for key in _WEIGHT_KEYS:
            path = model_cfg.get(key)
            if path and os.path.exists(str(path)):
                raise NotImplementedError(
                    f"model.{key}={path!r} exists: loading checkpoints is not ported yet")
        cfg = build_stllm_config(model_cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_stllm(gen, cfg)
        lora_r = int(model_cfg.get("lora_r", 0) or 0)
        if lora_r > 0:
            from stllm_tpu_torch.models.lora import add_lora

            params = add_lora(params, torch.Generator(device=dev).manual_seed(seed + 1), lora_r,
                              float(model_cfg.get("lora_alpha", 32)))
        if model_cfg.get("quant_int8", False):
            params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
            params["qformer"] = quantize_tree_linears(params["qformer"], free_dense=True)
            params["llama"] = quantize_llama_params(params["llama"], free_dense=True)
        return cls(cfg, params, dev, model_cfg=model_cfg)

    def chat(self, image_size: int = 224):
        """A ``Chat`` over this model, its tokenizers and its device."""
        from stllm_tpu_torch.conversation import Chat

        return Chat(self.params, self.cfg, self.llama_tokenizer,
                    qformer_tokenizer=self.qformer_tokenizer, image_size=image_size)

    def trainable_fn(self) -> Callable[[str], bool]:
        """The config's freezing policy (freeze_vit, freeze_qformer,
        freeze_LLM; each defaults to frozen) as a predicate on leaf paths."""
        from stllm_tpu_torch.train.step import default_trainable

        return default_trainable(
            freeze_vit=self.model_cfg.get("freeze_vit", True),
            freeze_qformer=self.model_cfg.get("freeze_qformer", True),
            freeze_llm=self.model_cfg.get("freeze_LLM", True),
        )


class ToyHashTokenizer:
    """Deterministic word-hash tokenizer with exact decode via a reverse map,
    for offline runs without real tokenizers (none load yet). crc32, not
    hash(): hash() is salted per process."""

    def __init__(self, vocab_size: int, reserve: int = 10):
        self.vocab_size = vocab_size
        self.reserve = reserve
        self.rev: Dict[int, str] = {}

    def encode(self, text, add_special_tokens=False):
        ids = [1] if add_special_tokens else []
        for w in text.split(" "):
            t = self.reserve + (zlib.crc32(w.encode()) % (self.vocab_size - self.reserve))
            self.rev[t] = w
            ids.append(t)
        return ids

    def decode(self, ids):
        return " ".join(self.rev.get(int(t), "<unk>") for t in ids if t > 1)


def ensure_tokenizers(model: STLLM, warn: bool = True) -> STLLM:
    """Install toy tokenizers where no real one is loaded (offline runs):
    the answers are gibberish, but encode, the stop sequences and decode all
    run."""
    if model.llama_tokenizer is None:
        if warn:
            logger.warning("no LLaMA tokenizer is loaded; using a toy hash tokenizer, "
                           "so answers are gibberish but every code path runs")
        model.llama_tokenizer = ToyHashTokenizer(model.cfg.llama.vocab_size)
    if model.cfg.qformer_text_input and model.qformer_tokenizer is None:
        model.qformer_tokenizer = ToyHashTokenizer(model.cfg.qformer.vocab_size, reserve=2)
    return model
