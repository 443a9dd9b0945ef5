#!/usr/bin/env python3
"""Time variants of the two Hopper GEMM forms on one CUDA card: the cluster
form of the fused-LayerNorm int8 GEMM (#11, csrc/qmm_res_ln.cu) and the
wgmma prefill form of the W4A16 matmul (#12, csrc/w4a16_prefill.cuh), each
held to its plain version first.

    python3 script/tune_hopper_gemms.py [--baseline OTHER/stllm_tpu_torch/csrc] [--out FILE]

A variant is the shipped source with some lines changed: the script copies
stllm_tpu_torch/csrc into a temporary directory, rewrites it there (the
checkout is not touched), builds the variant's library with nvcc as
ops/kernels.py builds it, and swaps it in for the kernel's own. #11 at the
ViT-g proj and fc2 sites ((16 x 257) x 1408 . 1408 x 1408 with per-row hs,
6144 -> 1408 with a scalar hs), beside the 16-row kernel it replaced; #12 at
the four Vicuna-7B shapes at M = 576 and 640. Times are
CUDA-graph replays cycling four input copies (chip_smoke.graph_ms). With
``--baseline`` each kernel is also built from another tree's sources (an
earlier design with the same entry points). Prints one JSON line per
variant and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "script"))

import tune_attention_loops  # noqa: E402
from tune_attention_loops import use_library  # noqa: E402

QMM = "qmm_res_ln.cu"
HOPPER = "hopper.cuh"

# #11: each CTA loads the whole hq tile itself (no multicast, no remote arrives)
_NO_MULTICAST = [
    (QMM, r"mbar_init\(&empty\[s\], kConsumers \* kC\);", "mbar_init(&empty[s], kConsumers);"),
    (QMM, r"tma_load_2d_multicast\(dst \+ rank \* kPiece \* kBK, &hq_map, &full\[stage\],\s*"
          r"static_cast<uint16_t>\(\(1u << kC\) - 1\), s \* kBK,\s*"
          r"m0 \+ static_cast<int>\(rank\) \* kPiece\);",
     "tma_load_2d(dst, &hq_map, &full[stage], s * kBK, m0);"),
    (QMM, r"for \(int r = 0; r < kC; \+\+r\) mbar_arrive_cluster\(&empty\[prev\], r\);",
     "mbar_arrive_cluster(&empty[prev], rank);"),
    (QMM, r"tensor_map_2d\(&hq_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, hq, K, M, K, kBK, kPiece\)",
     "tensor_map_2d(&hq_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, hq, K, M, K, kBK, kBM)"),
]
# #11: the remote arrives that free a stage with release semantics at cluster scope
_RELEASE_CLUSTER = (HOPPER, r"mbarrier\.arrive\.shared::cluster\.b64 _, \[remote\];",
                    "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];")

# #11: the producer warp, idle after its last copy, pulls the tile's x_prev
# rows of its slice into L2 for the epilogue
_PREFETCH = (QMM, r"(      if \(\+\+stage == kStages\) \{\n        stage = 0;\n        phase \^= 1;\n"
                  r"      \}\n    \}\n)(  \} else \{)",
             r"""\1    for (int r = 0; r < kBM && m0 + r < M; ++r) {
      const char* row = static_cast<const char*>(x_prev) +
          (static_cast<long long>(m0 + r) * N + static_cast<int>(rank) * S) * (io_f32 ? 4 : 2);
      const int bytes = S * (io_f32 ? 4 : 2);
      for (int off = 128 * lane; off < bytes + 127; off += 128 * 32) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(row + min(off, bytes - 1)));
      }
    }
\2""")
# #11: 64-row tiles (one consumer warpgroup), 3 stages, two CTAs an SM
_ROWS64 = [(QMM, r"constexpr int kBM = 128;", "constexpr int kBM = 64;"),
           (QMM, r"constexpr int kStages = 4;", "constexpr int kStages = 3;"),
           (QMM, r"constexpr int kBlocksPerSM = 1;", "constexpr int kBlocksPerSM = 2;")]
# #12: blocks that each load their own x tiles (clusters of one)
_CLUSTER1 = ("w4a16_prefill.cuh", r"constexpr int kClusterN = 2;", "constexpr int kClusterN = 1;")

VARIANTS = {
    "qmm_res_ln": [
        ("shipped", []),
        ("no multicast", _NO_MULTICAST),
        ("arrive.release.cluster", [_RELEASE_CLUSTER]),
        ("x_prev L2 prefetch", [_PREFETCH]),
        ("64-row tiles, 2 CTAs an SM", _ROWS64),
    ],
    "w4a16_matmul": [
        ("shipped", []),
        ("clusters of 1", [_CLUSTER1]),
    ],
}


def time_qmm(gen) -> dict:
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for label, b, s, k, n, per_row in (("proj", 16, 257, 1408, 1408, True),
                                       ("fc2", 16, 257, 6144, 1408, False)):
        bufs = []
        for _ in range(4):
            hs = (torch.rand(b, s, 1, generator=gen, device="cuda") * 0.01 + 1e-3
                  if per_row else torch.tensor(0.004, device="cuda"))
            codes = lambda *sh: torch.randint(-127, 128, sh, generator=gen, device="cuda",  # noqa
                                              dtype=torch.int8)
            vec = lambda m, sc, sh=0.0: (torch.randn(m, generator=gen, device="cuda") * sc  # noqa
                                         + sh).contiguous()
            bufs.append((codes(b, s, k), hs, codes(n, k).t(), vec(n, 0.0005, 0.001),
                         vec(n, 0.02), torch.randn(b, s, n, generator=gen,
                                                   device="cuda").bfloat16(),
                         vec(n, 0.1, 1.0), vec(n, 0.1),
                         torch.tensor(cs.RES_LN_OUT_SCALE, device="cuda"), 1e-6))
        row = {"shape": [label, b, s, k, n]}
        cluster = lambda *a: kernels._qmm_res_ln(*a, "cluster")  # noqa: E731
        cs._res_ln_err(cluster(*bufs[0]), kernels.qmm_res_ln_plain(*bufs[0]))
        cs._vs_parent(row, cluster, lambda *a: kernels._qmm_res_ln(*a, "rows"), bufs,
                      cs._res_ln_err, kernels.qmm_res_ln_plain, iters=20)
        out[label] = row
    return out


def time_w4(gen) -> dict:
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for m in (576, 640):
        for label, (k, n, pad) in cs.W4_SHAPES.items():
            bufs = []
            for _ in range(4):
                codes = lambda sh: torch.randint(-7, 8, sh, generator=gen,  # noqa: E731
                                                 device="cuda", dtype=torch.int8)
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                packed = torch.cat([kernels.pack_int4_nibbles(codes((k // 2, n)),
                                                              codes((k // 2, n))),
                                    torch.zeros((pad, n), dtype=torch.int8, device="cuda")])
                scale = 0.01 * (0.5 + torch.rand(n, generator=gen, device="cuda"))
                bufs.append((x, packed, scale.contiguous()))
            cs._ws_err(kernels.w4a16_matmul(*bufs[0]), kernels.w4a16_matmul_plain(*bufs[0]))
            it = iter(range(1 << 30))
            out[f"{label} M={m}"] = cs.graph_ms(
                lambda: kernels.w4a16_matmul(*bufs[next(it) % 4]), 20)
            del bufs
        out[f"32 layers M={m}"] = 32 * sum(v for key, v in out.items() if key.endswith(f" M={m}"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another tree's csrc (an earlier design)")
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("tune_hopper_gemms: no CUDA device", file=sys.stderr)
        return 1
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        from stllm_tpu_torch.ops import kernels

        builds = []        # every variant's nvcc at once, one per source
        for name, variants in VARIANTS.items():
            if args.baseline:
                variants = variants + [("baseline", [])]
            for i, (label, edits) in enumerate(variants):
                where = Path(tmp) / f"{name}-{i}"
                where.mkdir()
                shipped = kernels.CSRC
                if label == "baseline":
                    kernels.CSRC = args.baseline.resolve()
                try:
                    builds.append((name, label, *tune_attention_loops.start_build(
                        name, edits, where)))
                finally:
                    kernels.CSRC = shipped
        for name, label, proc, lib in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name} {label}: nvcc failed\n{log}")
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
            use_library(name, lib)
            gen = torch.Generator(device="cuda").manual_seed(0)
            res = time_qmm(gen) if name == "qmm_res_ln" else time_w4(gen)
            lines.append(json.dumps({"kernel": name, "variant": label, "registers": regs, **res}))
            print(lines[-1], flush=True)
    lines.append(cs.smi_line())
    print(lines[-1])
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
