"""The W4A16 unpack strategies of probe #15 at the 7B gate/up decode shape
(script/probe_w4_unpack.py).

x (16, 4096) @ w (4096, 11008), the weight's two halves' int4 codes packed
in one byte each way the reference tried:

  int32   nibbles, unpacked by 32-bit shifts (the production layout)
  int16   nibbles, unpacked by 16-bit shifts
  f32     biased p = 16 * b + (t + 8): b = floor(p / 16), t' = p - 16 b in
          fp32, and the +8 folded into a per-row correction -8 * sum(x_top)
  bf16    the same arithmetic in bf16
  and8    biased, t' = p & 15, b = (p - t') / 16

Each variant runs kernel #15 (``kernels.w4_unpack_matmul``). Before it is
timed it is held bit for bit to its plain version on inputs whose products
and sums are exact in fp32 (x small integers): equal bits then say the
unpack is right whatever order the sums run in. Then the reference's
chained repeats: REPS calls, each fed tanh of the last one's first 4096
columns in bf16, so they serialize; on the card the chain is captured once
in a CUDA graph and replayed, on the routed form (the tile loop at 16 rows,
``kernels.unpack_form``) and on the other (the decode form).

    python -m stllm_tpu_torch.timing.probe_w4_unpack [--reps N] [--cpu] [--out-dir DIR]

Merges its document into DIR/PROBE_W4_UNPACK.json (default timing_out/).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.probe_w4_unpack"
DOC = "PROBE_W4_UNPACK.json"
M, K, N = 16, 4096, 11008
REPS = 30
TIMED = 3          # replays of a captured chain


def codes(seed: int = 0, k: int = K, n: int = N):
    """The reference's codes: top and bottom halves in [-7, 7]."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(-7, 8, size=(k // 2, n)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-7, 8, size=(k // 2, n)).astype(np.int8))
    return t, b


def exact_x(m: int = M, k: int = K, seed: int = 2) -> torch.Tensor:
    """Integers in [-2, 2] as bf16: every product and partial sum of the
    unpacked matmul is an integer below 2^24, exact in fp32 in any order."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2, 3, size=(m, k)).astype(np.float32)).bfloat16()


def forms(device) -> tuple:
    """The forms timed on the card: the one #15's route picks at M rows,
    then the other; the route alone on the CPU."""
    if torch.device(device).type != "cuda":
        return ("plain",)
    routed = kernels.unpack_form(M)
    return (routed, "decode" if routed == "stream" else "stream")


def _call(x, packed, variant: str, form: str):
    if form == "plain":
        return kernels.w4_unpack_matmul(x, packed, variant)
    return kernels._w4_unpack_matmul(x, packed, variant, form)


@torch.no_grad()
def run_variant(variant: str, t: torch.Tensor, b: torch.Tensor, device,
                reps: int = REPS) -> Dict:
    """The variant's bit-exact check (through the routed wrapper) and its
    chained repeats on each form."""
    device = torch.device(device)
    packed = kernels.pack_int4_variant(variant, t, b).to(device)
    xe = exact_x().to(device)
    got = kernels.w4_unpack_matmul(xe, packed, variant).cpu()
    want = kernels.w4_unpack_matmul_plain(xe.cpu(), packed.cpu(), variant)
    out = {"bit_exact": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()), "ms_per_rep": {}}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(M, K)) * 0.1).to(
        device=device, dtype=torch.bfloat16)
    for form in forms(device):
        def chained():
            c = x
            for _ in range(reps):
                c = torch.tanh(_call(c, packed, variant, form)[:, :K]).to(torch.bfloat16)
            return c
        if device.type == "cuda":
            graph, _ = _common.capture(chained)
            ms = _common.replay_ms(graph, TIMED)
            del graph
            per_rep = float(np.mean(ms)) / reps
            out["ms_per_rep"][form] = per_rep
            out.setdefault("replay_ms", {})[form] = ms
        else:
            _, s = _common.clock(chained, device)
            out["ms_per_rep"][form] = s * 1e3 / reps
    best = min(out["ms_per_rep"].values())
    out["packed_read_gb_per_s"] = (K // 2 * N) / (best * 1e-3) / 1e9
    print(f"{variant:6s} bit_exact={out['bit_exact']} "
          + "  ".join(f"{f} {v:7.4f} ms/rep" for f, v in out["ms_per_rep"].items()), flush=True)
    return out


def expected_launches(reps: int, device) -> int:
    """#15's launches a variant on the card: the check, then on each of the
    two forms the capture's warm run and the capture, ``reps`` each."""
    return 1 + 2 * 2 * reps if torch.device(device).type == "cuda" else 0


def run(device, reps: int = REPS) -> Dict:
    t, b = codes()
    before = kernels.LAUNCHES["w4_unpack_matmul"]
    variants = {v: run_variant(v, t, b, device, reps) for v in kernels.W4_UNPACK_VARIANTS}
    return {"m": M, "k": K, "n": N, "reps": reps, "forms": list(forms(device)),
            "variants": variants, "launches": kernels.LAUNCHES["w4_unpack_matmul"] - before,
            "all_bit_exact": all(v["bit_exact"] for v in variants.values())}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="probe #15's unpack variants at (16, 4096) x (4096, 11008)")
    parser.add_argument("--reps", type=int, default=REPS,
                        help=f"chained calls a timed chain (default {REPS})")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    result = run(device, args.reps)
    print(json.dumps({v: r["ms_per_rep"] for v, r in result["variants"].items()}), flush=True)
    _common.merge_doc(args.out_dir, DOC,
                      lambda doc: doc.update(_common.stamp(result, device, HARNESS)))
    return 0 if result["all_bit_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
