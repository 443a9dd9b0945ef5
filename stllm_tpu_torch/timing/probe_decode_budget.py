"""Where do the 7B decode milliseconds go? The decode step's matmul
skeleton, per weight format (script/probe_decode_budget.py).

A matmul-only skeleton of the decode step: 32 layers x the 7 decoder
matmuls at Vicuna-7B shapes, one row (M = 1), each layer's input the last
one's output, chained over the 16 steps of the production decode's chunk.
Per variant:

  null    no matmuls (a mean broadcast)      -> the chunk's floor
  int8    the production W8A8 path (``ops.quant.quant_linear``)
  w8p     probe #14: int8 codes streamed, convert only
  w4      kernel #12 (W4A16, its decode form at M = 1)
  w4v3    probe #13: the arithmetic packing p = 16 * bottom + top
  w4fuse  #12 on q|k|v and gate|up each packed into one weight: four
          launches a layer instead of seven

The reference times the chunk inside one ``lax.scan``, one device call.
Here the chunk runs twice: eagerly, as the port's production decode runs
it (a Python call a matmul, every launch paid on the host), and captured
once in a CUDA graph and replayed (the launches without the host). The
difference is the host's share of a decode step. ``check_w4v3`` holds #13
to the plain unpack at (3, 2048) x (2048, 512) first.

    python -m stllm_tpu_torch.timing.probe_decode_budget [variants ...] [--calls N]
        [--cpu] [--out-dir DIR]

PROBE_LAYERS, PROBE_STEPS and PROBE_CALLS (default 32, 16, 4) set the depth,
the chunk and the timed calls, as in the reference (``--calls`` overrides
the last). Merges its document into
DIR/PROBE_DECODE_BUDGET.json (default timing_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops.quant import quant_linear
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.probe_decode_budget"
DOC = "PROBE_DECODE_BUDGET.json"
HID, FFN = 4096, 11008
LAYERS = int(os.environ.get("PROBE_LAYERS", "32"))
STEPS = int(os.environ.get("PROBE_STEPS", "16"))   # tokens a chunk
CALLS = int(os.environ.get("PROBE_CALLS", "4"))
VARIANTS = ("null", "int8", "w8p", "w4", "w4v3", "w4fuse")
SHAPES = [("q", HID, HID), ("k", HID, HID), ("v", HID, HID), ("o", HID, HID),
          ("gate", HID, FFN), ("up", HID, FFN), ("down", FFN, HID)]
# the kernel each variant launches once a matmul
KERNEL = {"w8p": "w8p_matmul", "w4": "w4a16_matmul", "w4v3": "w4v3_matmul",
          "w4fuse": "w4a16_matmul"}


def padded_k(k: int) -> int:
    """The reference's stored K: 11008 rows pad to 11264 (a 512 multiple);
    the kernels read only the rows x covers."""
    return k if k % 1024 == 0 else -(-k // 512) * 512


def _codes(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Small random int4 codes in [-3, 3]: activations stay bounded over 32
    layers."""
    return torch.randint(-3, 4, shape, generator=gen, device=device, dtype=torch.int8)


def build(variant: str, device, seed: int = 0) -> List[Dict]:
    """Per-layer dict of the variant's weights, made on ``device``; scales
    1 / (8 sqrt(K)) as the reference's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = []
    for _ in range(LAYERS):
        layer: Dict = {}
        for name, k, n in SHAPES:
            kk = padded_k(k)
            scale = torch.full((n,), 1.0 / (8 * np.sqrt(k)), dtype=torch.float32, device=device)
            if variant == "null":
                layer[name] = {"n": n}
            elif variant == "int8":      # quant_linear's column-major codes
                layer[name] = {"w_q": _codes(gen, (n, k), device).t(), "w_scale": scale}
            elif variant == "w8p":
                layer[name] = {"w_q": _codes(gen, (kk, n), device), "w_scale": scale}
            else:
                top, bottom = _codes(gen, (kk // 2, n), device), _codes(gen, (kk // 2, n), device)
                pack = kernels.pack_int4_arith if variant == "w4v3" else kernels.pack_int4_nibbles
                layer[name] = {"w4": pack(top, bottom), "w4_scale": scale}
        layers.append(layer)
    if variant == "w4fuse":      # q|k|v and gate|up each as one wide weight
        layers = [{"qkv": _fused(l, ("q", "k", "v")), "o": l["o"],
                   "gateup": _fused(l, ("gate", "up")), "down": l["down"]} for l in layers]
    return layers


def _fused(layer: Dict, names) -> Dict:
    return {"w4": torch.cat([layer[n]["w4"] for n in names], dim=1),
            "w4_scale": torch.cat([layer[n]["w4_scale"] for n in names])}


def apply_linear(variant: str, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if variant == "int8":
        return quant_linear(p, x)
    if variant == "w8p":
        return kernels.w8p_matmul(x, p["w_q"], p["w_scale"])
    if variant in ("w4", "w4fuse"):
        return kernels.w4a16_matmul(x, p["w4"], p["w4_scale"])
    if variant == "w4v3":
        return kernels.w4v3_matmul(x, p["w4"], p["w4_scale"])
    if variant == "null":
        return x.mean(dim=-1, keepdim=True).expand(x.shape[0], p["n"])
    raise ValueError(variant)


def make_step(variant: str, layers: List[Dict]) -> Callable[[torch.Tensor], torch.Tensor]:
    """One decode step of the skeleton: every layer's seven (or four) matmuls
    in the reference's order and mixing."""
    f = lambda p, x: apply_linear(variant, p, x)
    if variant == "w4fuse":
        def step(x):
            for l in layers:
                a, b, c = f(l["qkv"], x).chunk(3, dim=-1)
                h = f(l["o"], (a + b + c) / 3.0)
                g, u = f(l["gateup"], h).chunk(2, dim=-1)
                x = f(l["down"], torch.tanh(g) * u)
            return x
        return step

    def step(x):
        for l in layers:
            h = f(l["o"], (f(l["q"], x) + f(l["k"], x) + f(l["v"], x)) / 3.0)
            x = f(l["down"], torch.tanh(f(l["gate"], h)) * f(l["up"], h))
        return x
    return step


def make_chunk(variant: str, layers: List[Dict]) -> Callable[[torch.Tensor], torch.Tensor]:
    step = make_step(variant, layers)

    def chunk(x):
        for _ in range(STEPS):
            x = step(x)
        return x
    return chunk


def matmuls_per_step(variant: str) -> int:
    return 0 if variant == "null" else LAYERS * (4 if variant == "w4fuse" else 7)


@torch.no_grad()
def measure(variant: str, device, calls: int = CALLS) -> Dict:
    """The variant's chunk: a warm eager call, ``calls`` eager calls, each
    synchronized at both ends and its seconds kept, and on the card the
    chunk as one CUDA graph replayed ``calls`` times under CUDA events.
    Counts the variant's kernel launches."""
    device = torch.device(device)
    t0 = time.perf_counter()
    layers = build(variant, device)
    _common.sync(device)
    build_s = time.perf_counter() - t0
    chunk = make_chunk(variant, layers)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, HID))).to(
        device=device, dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    chunk(x)
    out, eager = _common.repeats(lambda: chunk(x), calls, device)
    result = {"weights_built_s": build_s, "eager_call_s": eager,
              "eager_ms_per_token": sum(eager) * 1e3 / (calls * STEPS)}
    if device.type == "cuda":
        graph, out = _common.capture(lambda: chunk(x))
        replay_ms = _common.replay_ms(graph, calls)
        graph_ms = float(np.mean(replay_ms)) / STEPS
        result.update(graph_replay_ms=replay_ms, graph_ms_per_token=graph_ms,
                      host_ms_per_token=result["eager_ms_per_token"] - graph_ms,
                      host_share=1.0 - graph_ms / result["eager_ms_per_token"])
        del graph
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{variant}: the chunk's output is not finite")
    result["launches"] = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v > before[k]}
    result["matmuls_per_step"] = matmuls_per_step(variant)
    print(f"{variant:6s} eager {result['eager_ms_per_token']:7.3f} ms/token"
          + (f", graph {result['graph_ms_per_token']:7.3f}" if "graph_ms_per_token" in result
             else ""), flush=True)
    return result


def expected_launches(variants, calls: int, device) -> Dict[str, int]:
    """The kernel launches ``run`` makes on the card: ``check_w4v3``'s one
    where w4v3 runs, then each variant's chunks in ``measure`` (the warm
    call, the ``calls`` timed ones, the side stream's warm run and the
    capture), STEPS steps each."""
    if torch.device(device).type != "cuda":
        return {}
    out: Dict[str, int] = {"w4v3_matmul": 1} if "w4v3" in variants else {}
    for v in variants:
        if v in KERNEL:
            out[KERNEL[v]] = out.get(KERNEL[v], 0) + (calls + 3) * STEPS * matmuls_per_step(v)
    return out


def check_w4v3(device) -> float:
    """#13 against the unpacked codes' product at (3, 2048) x (2048, 512),
    both on the bf16-rounded x the kernel multiplies: the max error relative
    to |want| + 1, below 2e-2 (fp32 sums in another order). The reference
    holds its kernel to an fp32-x product under the same bound, which the
    x rounding alone breaks near a zero output (0.733 on this seed, its
    own interpret-mode run on the CPU included)."""
    rng = np.random.default_rng(1)
    k, n, m = 2048, 512, 3
    top = torch.from_numpy(rng.integers(-7, 8, size=(k // 2, n)).astype(np.int8))
    bottom = torch.from_numpy(rng.integers(-7, 8, size=(k // 2, n)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    xb = x.bfloat16().float()
    want = (xb[:, :k // 2] @ top.float() + xb[:, k // 2:] @ bottom.float()) * scale
    got = kernels.w4v3_matmul(x.to(device), kernels.pack_int4_arith(top, bottom).to(device),
                              scale.to(device)).float().cpu()
    rel = float(((got - want).abs() / (want.abs() + 1.0)).max())
    if not rel < 2e-2:
        raise AssertionError(f"w4v3 numeric check: max rel err {rel:.2e}")
    print(f"w4v3 numeric check OK (max rel err {rel:.2e})", flush=True)
    return rel


def run(variants, device, calls: int = CALLS) -> Dict:
    out: Dict = {"layers": LAYERS, "steps": STEPS, "calls": calls, "variants": {}}
    if "w4v3" in variants:
        out["w4v3_check_max_rel_err"] = check_w4v3(device)
    for v in variants:
        out["variants"][v] = measure(v, device, calls)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="the 7B decode step's matmul skeleton per weight format, eager and as "
                    "one CUDA graph")
    parser.add_argument("variants", nargs="*", help=f"of {' '.join(VARIANTS)} (default all)")
    parser.add_argument("--calls", type=int, default=CALLS,
                        help=f"timed chunks of each variant (default PROBE_CALLS, {CALLS})")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    result = run(args.variants or list(VARIANTS), device, args.calls)
    print(json.dumps({v: {k: r.get(k) for k in ("eager_ms_per_token", "graph_ms_per_token",
                                                "host_share")}
                      for v, r in result["variants"].items()}), flush=True)
    _common.merge_doc(args.out_dir, DOC,
                      lambda doc: doc.update(_common.stamp(result, device, HARNESS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
