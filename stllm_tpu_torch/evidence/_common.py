"""What the evidence harnesses share word for word: the device and output
arguments, the device line each document carries, the merge-preserving JSON
files, the MVBench-shaped QA samples (16-frame video -> encode -> 608-token
prompt -> 16-token greedy answer, the reference protocol of
stllm/test/mvbench/mv_bench.py:229-283 with do_sample=False) and the
first-token margin."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stllm_tpu_torch.common.device import resolve_device
from stllm_tpu_torch.data.synth import synth_video
from stllm_tpu_torch.models.generation import GenerationConfig, _pad_prompt, _prefill, generate
from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img

FRAMES = 16
PREFIX_TOKENS = 64
SUFFIX_TOKENS = 32
ANSWER_TOKENS = 16

OUT_DIR = "evidence_out"
EQUIV_INT8 = "EQUIV_INT8.json"
TOME_EQUIV = "TOME_EQUIV.json"


def add_device_args(parser, out_dir: Optional[str] = OUT_DIR) -> None:
    """``--cpu``, and ``--out-dir`` defaulting to ``out_dir`` unless it is
    None."""
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the default is the CUDA card)")
    if out_dir is not None:
        parser.add_argument("--out-dir", default=out_dir,
                            help=f"directory of the JSON documents (default {out_dir}/)")


def pick_device(args, prog: str) -> Optional[torch.device]:
    """The CUDA card, or the CPU with ``--cpu``; None, after a message on
    stderr, when there is no card and ``--cpu`` was not passed."""
    try:
        return resolve_device("cpu" if args.cpu else None)
    except RuntimeError:
        print(f"{prog}: no CUDA device is available; pass --cpu to run on the CPU",
              file=sys.stderr)
        return None


def device_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the card ``device`` is on, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        lines = r.stdout.strip().splitlines()
        if r.returncode == 0 and lines:
            return lines[min(index, len(lines) - 1)].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read (nvidia-smi failed)"


def stamp(section: Dict, device, harness: str) -> Dict:
    """Add the two fields every section of the port's documents carries."""
    section["device"] = device_line(device)
    section["harness"] = harness
    return section


def read_doc(path: str) -> Dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except ValueError:
        return {}


def write_doc(path: str, doc: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({"written": path}), flush=True)


def qa_samples(n: int, cfg: STLLMConfig, video: bool) -> List[Dict[str, np.ndarray]]:
    """``n`` host-side (numpy) samples from ``default_rng(7)``: 16 frames
    (smooth synthetic video, or iid uint8 noise), 16 Q-Former question ids,
    and the 64-token prefix and 32-token suffix embeddings of the prompt."""
    rng = np.random.default_rng(7)
    d = cfg.llama.hidden
    s = cfg.vit.image_size
    samples = []
    for _ in range(n):
        frames = (synth_video(rng, FRAMES, s) if video else
                  rng.integers(0, 256, (1, FRAMES, s, s, 3)).astype(np.uint8))
        samples.append({
            "frames": frames,
            "q_ids": rng.integers(0, cfg.qformer.vocab_size, (1, 16)).astype(np.int32),
            "q_mask": np.ones((1, 16), np.int32),
            "prefix": (rng.normal(size=(1, PREFIX_TOKENS, d)) * 0.02).astype(np.float32),
            "suffix": (rng.normal(size=(1, SUFFIX_TOKENS, d)) * 0.02).astype(np.float32),
        })
    return samples


def qa_embeds(params: Dict, cfg: STLLMConfig, sample: Dict[str, np.ndarray]) -> torch.Tensor:
    """Encode the sample's video and assemble prefix | video | suffix
    (1, 608, d) in the LLaMA's dtype, on the params' device."""
    dev = params["llama"]["embed_tokens"].device
    t = lambda a: torch.from_numpy(a).to(dev)
    vid = encode_img(params, t(sample["frames"]), cfg, t(sample["q_ids"]), t(sample["q_mask"]))
    dtype = cfg.llama.dtype
    return torch.cat([t(sample["prefix"]).to(dtype), vid.reshape(1, -1, cfg.llama.hidden),
                      t(sample["suffix"]).to(dtype)], dim=1)


def answer_gen() -> GenerationConfig:
    """The greedy 16-token answer with no stop: every answer is full length."""
    return GenerationConfig(max_new_tokens=ANSWER_TOKENS, stop_sequences=(), eos_token_id=-1)


@torch.no_grad()
def first_token_margin(llama_params: Dict, embeds: torch.Tensor, llama_cfg,
                       pad_to_multiple: int, max_new_tokens: int) -> float:
    """top1 - top2 logit gap at the answer position: the noise floor below
    which any perturbation (quantization included) flips the greedy token."""
    b, s, _ = embeds.shape
    mask = torch.ones((b, s), dtype=torch.int32, device=embeds.device)
    e, m = _pad_prompt(embeds, mask, pad_to_multiple)
    logits, _ = _prefill(llama_params, e, m, llama_cfg, e.shape[1] + max_new_tokens)
    top2 = torch.topk(logits[0].float(), 2).values
    return float(top2[0] - top2[1])


@torch.no_grad()
def run_samples(params: Dict, cfg: Union[STLLMConfig, Callable[[Dict], STLLMConfig]],
                samples: List[Dict], label: str) -> Tuple[List[List[int]], List[float]]:
    """Greedy answers and their first-token margins. ``cfg`` is an
    STLLMConfig, or a callable sample -> STLLMConfig (the auto merge arm
    resolves a level per video)."""
    cfg_fn = cfg if callable(cfg) else (lambda s: cfg)
    gen = answer_gen()
    outs, margins = [], []
    t0 = time.perf_counter()
    for s in samples:
        c = cfg_fn(s)
        embeds = qa_embeds(params, c, s)
        outs.append(list(generate(params["llama"], embeds, llama_cfg=c.llama, gen=gen)[0]))
        margins.append(first_token_margin(params["llama"], embeds, c.llama,
                                          gen.pad_to_multiple, gen.max_new_tokens))
    dt = time.perf_counter() - t0
    print(f"[{label}] {len(samples)} samples in {dt:.1f}s "
          f"({dt / max(len(samples), 1) * 1e3:.0f} ms/sample)", file=sys.stderr, flush=True)
    return outs, margins

