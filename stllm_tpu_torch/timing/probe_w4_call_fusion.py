"""Does fusing the decode's W4A16 matmuls cut their cost? Kernel #12 on
split against fused q|k|v and gate|up (script/probe_w4_call_fusion.py).

At the 7B decode shapes (one row, K = 4096), 32 chained steps of:

  qkv split (3 calls)   three (4096, 4096) weights, the outputs summed
  qkv fused (1 call)    one (4096, 12288) weight, its thirds summed
  mlp split (3 calls)   gate and up (4096, 11008), silu(gate) * up into down
  mlp fused (2 calls)   gate|up as one (4096, 22016) weight, then down

each weight per-channel int4 from ``ops.quant.quantize_weights_int4`` of
bf16 normals x 0.02, every matmul ``kernels.w4a16_matmul`` (its decode form
at one row). The reference times its steps inside one ``lax.scan``; here
each arm runs eagerly (a Python call a launch, as the port's decode runs)
and captured once in a CUDA graph and replayed.

    python -m stllm_tpu_torch.timing.probe_w4_call_fusion [--iters N] [--cpu]
        [--out-dir DIR]

Merges its document into DIR/PROBE_W4_CALL_FUSION.json (default timing_out/).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops.quant import quantize_weights_int4
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.probe_w4_call_fusion"
DOC = "PROBE_W4_CALL_FUSION.json"
D, FFN, STEPS = 4096, 11008, 32
ITERS = 30
# launches of #12 a step of each arm
CALLS = {"qkv split (3 calls)": 3, "qkv fused (1 call)": 1, "mlp split (3 calls)": 3,
         "mlp fused (2 calls)": 2}


def inputs(device, seed: int = 0) -> Tuple[torch.Tensor, Dict]:
    """The probe's (1, D) bf16 input and its int4 weights, packed (K/2, N)
    with per-channel scales, drawn in the reference's order from one
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(1, D))).to(device=device, dtype=torch.bfloat16)

    def w4(shape):
        w = torch.from_numpy(rng.normal(size=shape) * 0.02).to(device=device,
                                                              dtype=torch.bfloat16)
        return quantize_weights_int4(w, group=None)

    w = {"qkv": [w4((D, D)) for _ in range(3)], "qkv_fused": w4((D, 3 * D))}
    w.update(gate_up=[w4((D, FFN)) for _ in range(2)], gate_up_fused=w4((D, 2 * FFN)),
             down=w4((FFN, D)))
    return x0, w


def arms(w: Dict) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    mm = lambda x, ps: kernels.w4a16_matmul(x, *ps)

    def qkv_split(x):
        a, b, c = (mm(x, p) for p in w["qkv"])
        return a + b + c

    def qkv_fused(x):
        y = mm(x, w["qkv_fused"])
        return y[:, :D] + y[:, D:2 * D] + y[:, 2 * D:]

    def mlp_split(x):
        g, u = (mm(x, p) for p in w["gate_up"])
        return mm(F.silu(g) * u, w["down"])

    def mlp_fused(x):
        y = mm(x, w["gate_up_fused"])
        return mm(F.silu(y[:, :FFN]) * y[:, FFN:], w["down"])

    return dict(zip(CALLS, (qkv_split, qkv_fused, mlp_split, mlp_fused)))


@torch.no_grad()
def bench(step: Callable, x0: torch.Tensor, device, iters: int = ITERS) -> Dict:
    """STEPS chained steps: a warm run, ``iters`` eager runs (each
    synchronized, its seconds kept) and on the card the chain as one CUDA
    graph replayed ``iters`` times; ms a step of each. The first step's
    output must be finite; the chain's need not be (as the reference's, its
    activations grow step over step until bf16 overflows, which no kernel
    here branches on)."""
    def run():
        x = x0
        for _ in range(STEPS):
            x = step(x)
        return x

    if not torch.isfinite(step(x0).float()).all():
        raise AssertionError("the first step's output is not finite")
    run()
    _, eager = _common.repeats(run, iters, device)
    result = {"eager_call_s": eager, "eager_ms_per_step": sum(eager) * 1e3 / (iters * STEPS)}
    if torch.device(device).type == "cuda":
        graph, _ = _common.capture(run)
        ms = _common.replay_ms(graph, iters)
        del graph
        result.update(graph_replay_ms=ms, graph_ms_per_step=float(np.mean(ms)) / STEPS)
    return result


def expected_launches(iters: int, device) -> int:
    """#12's launches over the four arms on the card: the first step alone,
    then a warm run, ``iters`` eager runs, the capture's warm run and the
    capture, STEPS steps each."""
    if torch.device(device).type != "cuda":
        return 0
    return (1 + (iters + 3) * STEPS) * sum(CALLS.values())


def run(device, iters: int = ITERS) -> Dict:
    x0, w = inputs(device)
    before = kernels.LAUNCHES["w4a16_matmul"]
    out = {}
    for name, step in arms(w).items():
        out[name] = bench(step, x0, device, iters)
        print(f"{name:22s} eager {out[name]['eager_ms_per_step']:.3f} ms/step"
              + (f", graph {out[name]['graph_ms_per_step']:.3f}"
                 if "graph_ms_per_step" in out[name] else ""), flush=True)
    return {"steps": STEPS, "iters": iters, "arms": out,
            "launches": kernels.LAUNCHES["w4a16_matmul"] - before}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="kernel #12 on split against fused q|k|v and gate|up at the 7B decode "
                    "shapes")
    parser.add_argument("--iters", type=int, default=ITERS,
                        help=f"timed runs of each arm (default {ITERS})")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    result = run(device, args.iters)
    print(json.dumps({k: {m: v.get(m) for m in ("eager_ms_per_step", "graph_ms_per_step")}
                      for k, v in result["arms"].items()}), flush=True)
    _common.merge_doc(args.out_dir, DOC,
                      lambda doc: doc.update(_common.stamp(result, device, HARNESS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
