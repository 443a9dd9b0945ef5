#!/usr/bin/env python3
"""Time variants of the Hopper GEMM forms on one CUDA card: the cluster
form of the fused-LayerNorm int8 GEMM (#11, csrc/qmm_res_ln.cu), the wgmma
prefill form and the decode form of the W4A16 matmul (#12,
csrc/w4a16_prefill.cuh, csrc/w4a16_decode.cuh) and the blockwise dynamic
W8A8 matmul (#8, csrc/quant_matmul.cu), and the decode form's modes of the
probes #13-#15, each held to its plain version first.

    python3 script/tune_hopper_gemms.py [--only KEY ...] [--baseline OTHER/stllm_tpu_torch/csrc]
                                        [--out FILE]

A variant is the shipped source with some lines changed: the script copies
stllm_tpu_torch/csrc into a temporary directory, rewrites it there (the
checkout is not touched), builds the variant's library with nvcc as
ops/kernels.py builds it, and swaps it in for the kernel's own. #11 at the
ViT-g proj and fc2 sites ((16 x 257) x 1408 . 1408 x 1408 with per-row hs,
6144 -> 1408 with a scalar hs), beside the 16-row kernel it replaced; #12 at
the four Vicuna-7B shapes at M = 576 and 640 (key w4a16_matmul) and, for the
decode form, at M = 4 (key w4a16_matmul/decode) at the CTAs along K its
rule gives (variants change the rule's kMaxCluster and kTargetCTAs) and the
tile loop beside it (the same in every variant's library); the probes #13
and #14 on the decode form's kArith and kInt8 modes (keys
w4v3_matmul/decode, w8p_matmul/decode) at the decode-budget probe's seven
shapes at M = 1, the tile loop beside them; #15's five unpack variants
(key w4_unpack_matmul/decode) at the unpack probe's (16, 4096, 11008), the
tile loop and #12's decode form on the same codes beside them; #8 (key
quant_matmul_blockwise) at its fc1 and fc2 shapes ((16 x 257) x 1408 ->
6144, one k-block; 6144 -> 1408, three; 1408 -> 1408, one), bf16, the
whole call (quant pass and GEMM), variants of the GEMM's tile widths, ring
depth, overlap and persistence; the variants marked "diagnostic" drop work (the tensor-core products, or also the
unpack) and are not held to the plain version. Times are CUDA-graph
replays cycling input copies (chip_smoke.graph_ms; the decode form's
copies more than the 50 MB L2 holds, chip_smoke.w4_copies). With
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

# #12's decode form: CTA shapes (128-column slices, K groups), ring depth,
# cluster limit, CTAs a call, and diagnostics that drop work or move the
# reads
DECODE = "w4a16_decode.cuh"


def _decode(slices: int = 1, kgroups: int = 2, stages: int = 4, clusters: int = 16,
            target: int = 512) -> list:
    return [(DECODE, r"constexpr int kSlices = 1;", f"constexpr int kSlices = {slices};"),
            (DECODE, r"constexpr int kKGroups = 2;", f"constexpr int kKGroups = {kgroups};"),
            (DECODE, r"constexpr int kStages = 4;", f"constexpr int kStages = {stages};"),
            (DECODE, r"constexpr int kMaxCluster = 16;",
             f"constexpr int kMaxCluster = {clusters};"),
            (DECODE, r"constexpr int kTargetCTAs = 512;", f"constexpr int kTargetCTAs = {target};")]


# (the products of one mode's branch: the nibble mode's at 10 spaces of
# indent, the arithmetic mode's at 12)
def _decode_no_mma(indent: int) -> tuple:
    return (DECODE, rf"(?m)^ {{{indent}}}wsm::mma_bf16\(acc\[h\]\[j\], top, xt\[h\]\.x, "
                    r"xt\[h\]\.y\);\s*wsm::mma_bf16\(acc\[h\]\[j\], bot, xb\[h\]\.x, xb\[h\]\.y\);",
            "acc[h][j][0] += __uint_as_float((top[0] ^ top[3] ^ bot[0] ^ bot[3] ^ xt[h].x "
            "^ xb[h].y) & 0x3fffffffu);")


_DECODE_NO_MMA = _decode_no_mma(10)
_DECODE_NO_UNPACK = (DECODE, r"const uint32_t top\[4\] = \{[^;]*\};\s*const uint32_t bot\[4\] = "
                             r"\{[^;]*\};",
                     "const uint32_t top[4] = {p01, p01, p23, p23}, bot[4] = {p23, p23, p01, p01};")
# the same bytes a step copies, read from one contiguous span of device memory
# (the matrix as if stored tile by tile)
_DECODE_CONTIGUOUS = (
    DECODE, r"const int8_t\* src = packed \+ static_cast<long long>\(k\) \* N \+ col;",
    "const int8_t* src = packed + ((static_cast<long long>(blockIdx.y) * ((kw + 15) / 16) + "
    "k / 16) * (16 * kBN) + (k % 16) * kBN + 16 * chunk) % (static_cast<long long>(kw) * N);")
_LOADS_ONLY = [_DECODE_NO_MMA, _DECODE_NO_UNPACK]
# the probes' modes (#13 kArith, #14 kInt8): no products; and no byte
# conversion either (the raw words stand in for the bf16 pairs), nor #13's
# split
_ARITH_NO_MMA = _decode_no_mma(12)
_INT8_NO_MMA = (DECODE, r"for \(int h = 0; h < MT; \+\+h\) wsm::mma_bf16\(acc\[h\]\[j\], a, "
                        r"xt\[h\]\.x, xt\[h\]\.y\);",
                "for (int h = 0; h < MT; ++h) acc[h][j][0] += __uint_as_float((a[0] ^ a[3] ^ "
                "xt[h].x) & 0x3fffffffu);")
_NO_CONVERT = (DECODE, r"const float fa = [^;]*;\s*const float fb = [^;]*;\s*"
                       r"return wsm::bits_of\(__floats2bfloat162_rn\(fa, fb\)\);",
               "return __byte_perm(wa, wb, 0x5140u | I);")
_NO_SPLIT = (DECODE, r"for \(int q = 0; q < 4; \+\+q\) arith_split\(a\[q\], top\[q\], bot\[q\]\);",
             "for (int q = 0; q < 4; ++q) top[q] = bot[q] = a[q];")

# #15's modes: no products; no unpack (each pair word stands in for its
# bf16 pairs); the kernel's register cap from 6 or 4 CTAs an SM (8 shipped)
_PROBE_NO_MMA = (DECODE, r"(probe_pair<MODE>\(p23 >> 8, top\[3\], bot\[3\]\);\s*"
                         r"#pragma unroll\s*for \(int h = 0; h < MT; \+\+h\) \{\s*)"
                         r"wsm::mma_bf16\(acc\[h\]\[j\], top, xt\[h\]\.x, xt\[h\]\.y\);\s*"
                         r"wsm::mma_bf16\(acc\[h\]\[j\], bot, xb\[h\]\.x, xb\[h\]\.y\);",
                 r"\1acc[h][j][0] += __uint_as_float((top[0] ^ top[3] ^ bot[0] ^ bot[3] ^ "
                 r"xt[h].x ^ xb[h].y) & 0x3fffffffu);")
_PROBE_NO_UNPACK = (DECODE, r"__nv_bfloat16 ta, ba, tb, bb;[^}]*bot = wsm::pack2\(ba, bb\);",
                    "top = w;\n  bot = w >> 4;")
_PROBE_BLOCKS = lambda n: (DECODE, r"__launch_bounds__\(kThreads, 16 / kWarps\)",  # noqa: E731
                           f"__launch_bounds__(kThreads, {n})")

# #8: the GEMM's tile widths (one k-block; more than one), the ring's depth,
# the wgmma wait, persistence, and a diagnostic without the products
QM8 = "quant_matmul.cu"


def _widths(one: str, more: str) -> list:
    return [(QM8, r"constexpr int kWidths1\[\] = \{256, 128\};",
             f"constexpr int kWidths1[] = {{{one}}};"),
            (QM8, r"constexpr int kWidthsN\[\] = \{128\};",
             f"constexpr int kWidthsN[] = {{{more}}};")]


# #8: no setmaxnreg (one producer warp, every thread within the 168
# registers of a 384-thread CTA)
_QM8_NO_SETMAXNREG = [(QM8, r"constexpr int kThreads = \(kConsumers \+ 1\) \* 128;",
                       "constexpr int kThreads = kConsumers * 128 + 32;"),
                      (QM8, r"    setmaxnreg_dec<kProducerRegs>\(\);\n", ""),
                      (QM8, r"    setmaxnreg_inc<kConsumerRegs>\(\);\n", "")]
_QM8_STAGES = lambda n: (QM8, r"constexpr int kMaxStages = 8;",  # noqa: E731
                         f"constexpr int kMaxStages = {n};")
_QM8_WAIT0 = (QM8, r"wgmma_wait<1>\(\);( +// the previous stage)", r"wgmma_wait<0>();\1")
_QM8_ONE_TILE = (QM8, r"const int ctas = tiles < sms \? static_cast<int>\(tiles\) : sms;",
                 "const int ctas = static_cast<int>(tiles);")
# #8: tiles walked column tile fastest (the CTAs at work share codes tiles
# rather than weight tiles)
_QM8_N_FASTEST = [
    (QM8, rf"(?m)^      const int m0 = tile % m_tiles \* kBM;\n      const int n0 = "
          rf"tile / m_tiles \* BN;\n{follow}",
     f"      const int m0 = tile / (tiles / m_tiles) * kBM;\n"
     f"      const int n0 = tile % (tiles / m_tiles) * BN;\n{follow}")
    for follow in ("      for", "      const int ra")]
_QM8_NO_EPILOGUE = (QM8, r"(      // epilogue: the last k-block's fold, times w_scale, cast; staged and\n)",
                    r"      if (tiles > 0) continue;   // no epilogue\n\1")
_QM8_DIRECT = (QM8, r"const int tma_out = Layout<BN>::kStaged && !out_f32 && N % 8 == 0;",
               "const int tma_out = 0;")
_QM8_NO_MMA = (QM8, r"for \(int j = 0; j < kBK / 32; \+\+j\) wgmma_s8<BN>\(acc, da \+ 2 \* j, "
                    r"db \+ 2 \* j, s % spb \| j\);",
               "acc[0] += static_cast<int>(da ^ db);")

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
    "quant_matmul_blockwise": [
        ("shipped", []),
        ("tiles 128 wide", _widths("128", "128")),
        ("tiles 256 wide at one k-block", _widths("256", "128")),
        ("no setmaxnreg", _QM8_NO_SETMAXNREG),
        ("3 stages", [_QM8_STAGES(3)]),
        ("2 stages", [_QM8_STAGES(2)]),
        ("no wgmma in flight across stages", [_QM8_WAIT0]),
        ("one tile a CTA (not persistent)", [_QM8_ONE_TILE]),
        ("column tile fastest", _QM8_N_FASTEST),
        ("stores from registers (no staging, no TMA stores)", [_QM8_DIRECT]),
        ("diagnostic: no products", [_QM8_NO_MMA]),
        ("diagnostic: no epilogue", [_QM8_NO_EPILOGUE]),
        ("diagnostic: loads only (no products, no epilogue)", [_QM8_NO_MMA, _QM8_NO_EPILOGUE]),
    ],
    "w4a16_matmul/decode": [
        ("shipped", _decode()),
        ("1 K group", _decode(kgroups=1)),
        ("4 K groups", _decode(kgroups=4)),
        ("256 columns", _decode(slices=2)),
        ("512 columns, 1 K group", _decode(slices=4, kgroups=1)),
        ("6 stages", _decode(stages=6)),
        ("clusters to 8", _decode(clusters=8)),
        ("clusters to 4", _decode(clusters=4)),
        ("clusters of 1", _decode(clusters=1)),
        ("256 CTAs a call", _decode(target=256)),
        ("1024 CTAs a call", _decode(target=1024)),
        ("diagnostic: no products", _decode() + [_DECODE_NO_MMA]),
        ("diagnostic: loads only", _decode() + _LOADS_ONLY),
        ("diagnostic: loads only, 512 columns, 1 K group",
         _decode(slices=4, kgroups=1) + _LOADS_ONLY),
        ("diagnostic: loads only, tile-contiguous reads",
         _decode() + _LOADS_ONLY + [_DECODE_CONTIGUOUS]),
    ],
    "w4v3_matmul/decode": [
        ("shipped", _decode()),
        ("clusters to 8", _decode(clusters=8)),
        ("1024 CTAs a call", _decode(target=1024)),
        ("diagnostic: no products", _decode() + [_ARITH_NO_MMA]),
        ("diagnostic: loads only (no products, no conversion, no split)",
         _decode() + [_ARITH_NO_MMA, _NO_CONVERT, _NO_SPLIT]),
    ],
    "w8p_matmul/decode": [
        ("shipped", _decode()),
        ("1 K group", _decode(kgroups=1)),
        ("4 K groups", _decode(kgroups=4)),
        ("6 stages", _decode(stages=6)),
        ("clusters to 8", _decode(clusters=8)),
        ("256 CTAs a call", _decode(target=256)),
        ("1024 CTAs a call", _decode(target=1024)),
        ("diagnostic: no products", _decode() + [_INT8_NO_MMA]),
        ("diagnostic: loads only (no products, no conversion)",
         _decode() + [_INT8_NO_MMA, _NO_CONVERT]),
    ],
}


VARIANTS["w4_unpack_matmul/decode"] = [
    ("shipped", _decode()),
    ("1 K group", _decode(kgroups=1)),
    ("3 K groups", _decode(kgroups=3)),
    ("4 K groups", _decode(kgroups=4)),
    ("256 columns", _decode(slices=2)),
    ("6 stages", _decode(stages=6)),
    ("clusters to 8", _decode(clusters=8)),
    ("256 CTAs a call", _decode(target=256)),
    ("1024 CTAs a call", _decode(target=1024)),
    ("registers for 6 CTAs an SM", _decode() + [_PROBE_BLOCKS(6)]),
    ("registers for 4 CTAs an SM", _decode() + [_PROBE_BLOCKS(4)]),
    ("diagnostic: no products", _decode() + [_PROBE_NO_MMA]),
    ("diagnostic: no unpack", _decode() + [_PROBE_NO_UNPACK]),
    ("diagnostic: loads only (no products, no unpack)",
     _decode() + [_PROBE_NO_MMA, _PROBE_NO_UNPACK]),
]


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


def time_w4_decode(gen, checked: bool) -> dict:
    """#12's decode form at M = 4, the four Vicuna-7B shapes, at the CTAs
    along K that the built variant's rule gives (kMaxCluster, kTargetCTAs),
    the tile loop beside it, and 32-layer totals."""
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for label, (k, n, pad) in cs.W4_SHAPES.items():
        bufs = []
        for _ in range(cs.w4_copies(k // 2 * n)):
            codes = lambda sh: torch.randint(-7, 8, sh, generator=gen,  # noqa: E731
                                             device="cuda", dtype=torch.int8)
            x = torch.randn(4, k, generator=gen, device="cuda").bfloat16()
            packed = torch.cat([kernels.pack_int4_nibbles(codes((k // 2, n)), codes((k // 2, n))),
                                torch.zeros((pad, n), dtype=torch.int8, device="cuda")])
            scale = 0.01 * (0.5 + torch.rand(n, generator=gen, device="cuda"))
            bufs.append((x, packed, scale.contiguous()))
        row = {}

        def timed(fn):
            it = iter(range(1 << 30))
            return cs.graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), 40)

        decode = lambda *a: kernels._w4a16_matmul(*a, "decode")  # noqa: E731
        if checked:
            cs._ws_err(decode(*bufs[0]), kernels.w4a16_matmul_plain(*bufs[0]))
        row["decode"] = timed(decode)
        row["tile loop"] = timed(lambda *a: kernels._w4a16_matmul(*a, "stream"))
        # a yardstick of reading the same bytes: torch's sum of the packed
        # weight as int64 words
        row["torch sum of the weight"] = timed(
            lambda x, p, s: p[:k // 2].view(torch.int64).sum())
        out[label] = row
        del bufs
    out["32 layers"] = {f: 32 * sum(r[f] for r in out.values()) for f in ("decode", "tile loop")}
    return out


def time_probe_decode(gen, checked: bool, name: str) -> dict:
    """#13 (name w4v3_matmul) or #14 (w8p_matmul) at the decode-budget
    probe's seven shapes at M = 1 on the decode form, the tile loop beside
    it, cycling w4_copies input copies, and the seven shapes x 32 layers."""
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    forced = kernels._w4v3_matmul if name == "w4v3_matmul" else kernels._w8p_matmul
    plain = kernels.w4v3_matmul_plain if name == "w4v3_matmul" else kernels.w8p_matmul_plain
    out = {}
    for label, k, n in cs.PROBE_SHAPES:
        rows = k // 2 if name == "w4v3_matmul" else k
        bufs = [(torch.randn(1, k, generator=gen, device="cuda").bfloat16(),
                 torch.randint(-128, 128, (rows, n), generator=gen, device="cuda",
                               dtype=torch.int8),
                 0.001 * (0.5 + torch.rand(n, generator=gen, device="cuda")))
                for _ in range(cs.w4_copies(rows * n))]

        def timed(fn):
            it = iter(range(1 << 30))
            return cs.graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), 40)

        decode = lambda *a: forced(*a, "decode")  # noqa: E731
        if checked:
            cs._ws_err(decode(*bufs[0]), plain(*bufs[0]))
        out[label] = {"decode": timed(decode), "tile loop": timed(lambda *a: forced(*a, "stream"))}
        del bufs
    out["32 layers"] = {f: 32 * sum(r[f] for r in out.values()) for f in ("decode", "tile loop")}
    return out


REPEATS = 20                        # bitwise repeats of each decode-form check (#15)


def time_unpack_decode(gen, checked: bool) -> dict:
    """#15's five variants at the unpack probe's (16, 4096, 11008) on the
    decode form, the tile loop beside each, cycling w4_copies input copies
    (each variant its layout of the same codes), and #12's decode form on
    the same codes in the nibble layout at unit scale (a yardstick the
    variant's library does not change); then the int32 and f32 variants and
    #12 at 8 and 4 rows (one n8 tile of x rows). Checked (not a
    diagnostic): each variant's decode form is held to its plain version on
    every copy at 16 and at 8 rows, and run REPEATS more times on each,
    each output compared bit for bit with the first (the form sums in a
    fixed order, so a difference is a race); failures are counted in the
    result, not raised, so that one variant does not hide the others."""
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    m, k, n = cs.UNPACK_SHAPE
    copies = cs.w4_copies(k // 2 * n)
    codes = lambda: torch.randint(-7, 8, (k // 2, n), generator=gen,  # noqa: E731
                                  device="cuda", dtype=torch.int8)
    src = [((torch.randn(m, k, generator=gen, device="cuda") * 0.1).bfloat16(), codes(), codes())
           for _ in range(copies)]

    def timed(fn, bufs):
        it = iter(range(1 << 30))
        return cs.graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), 40)

    def held(variant, rows) -> dict:
        bufs = [(x[:rows], kernels.pack_int4_variant(variant, t, b), variant) for x, t, b in src]
        errors, mismatches, worst = [], 0, 0.0
        for buf in bufs:
            first = kernels._w4_unpack_matmul(*buf, "decode")
            try:
                worst = max(worst, cs._ws_err(first, kernels.w4_unpack_matmul_plain(*buf)))
            except AssertionError as e:
                errors.append(str(e))
            for _ in range(REPEATS):
                mismatches += not torch.equal(kernels._w4_unpack_matmul(*buf, "decode"), first)
        return {"max_abs_err": worst, "errors": errors, "runs": len(bufs) * (REPEATS + 1),
                "repeat_mismatches": mismatches}

    one = torch.ones(n, device="cuda")
    out = {"w4a16 decode, same codes": timed(
        lambda *a: kernels._w4a16_matmul(*a, "decode"),
        [(x, kernels.pack_int4_nibbles(t, b), one) for x, t, b in src])}
    for variant in kernels.W4_UNPACK_VARIANTS:
        bufs = [(x, kernels.pack_int4_variant(variant, t, b), variant) for x, t, b in src]
        decode = lambda *a: kernels._w4_unpack_matmul(*a, "decode")  # noqa: E731
        code = kernels.W4_UNPACK_VARIANTS.index(variant)
        out[variant] = {"held": {rows: held(variant, rows) for rows in (16, 8)}} if checked else {}
        out[variant] |= {"decode": timed(decode, bufs),
                         "tile loop": timed(lambda *a: kernels._w4_unpack_matmul(*a, "stream"),
                                            bufs),
                         "registers": kernels.occupancy("w4_unpack_matmul", code, m, 1),
                         "blocks_per_sm": kernels.occupancy("w4_unpack_matmul", code, m, 0)}
        del bufs
    for rows in (8, 4):
        out[f"w4a16 decode, same codes, M={rows}"] = timed(
            lambda *a: kernels._w4a16_matmul(*a, "decode"),
            [(x[:rows], kernels.pack_int4_nibbles(t, b), one) for x, t, b in src])
        for variant in ("int32", "f32"):
            bufs = [(x[:rows], kernels.pack_int4_variant(variant, t, b), variant)
                    for x, t, b in src]
            out[f"{variant} M={rows}"] = {
                f: timed(lambda *a: kernels._w4_unpack_matmul(*a, f), bufs)
                for f in ("decode", "stream")}
            del bufs
    return out


def time_blockwise(gen, checked: bool) -> dict:
    """#8 at its fc1, fc2 and proj shapes, bf16, four input copies cycled
    (the width rule picks 256 columns at fc1, 128 at proj and fc2)."""
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels, quant

    out = {}
    for label, k, n in (("fc1", 1408, 6144), ("fc2", 6144, 1408), ("proj", 1408, 1408)):
        bk = quant._pick_tile(k, 2048)
        bufs = [(torch.randn(16, 257, k, generator=gen, device="cuda").bfloat16(),
                 torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                               dtype=torch.int8).t(),
                 torch.rand(n, generator=gen, device="cuda") * 0.002, bk) for _ in range(4)]
        if checked:
            cs._ws_err(kernels.quant_matmul_blockwise(*bufs[0]),
                       kernels.quant_matmul_blockwise_plain(*bufs[0]))
        it = iter(range(1 << 30))
        out[label] = cs.graph_ms(lambda: kernels.quant_matmul_blockwise(*bufs[next(it) % 4]), 20)
        out[f"{label} tile columns"] = kernels.occupancy("quant_matmul_blockwise", 16 * 257, k,
                                                         n, bk, 0, 2)
        out[f"{label} quant pass"] = cs.graph_ms(
            lambda: kernels._blockwise_quant_pass(bufs[next(it) % 4][0], bk), 20)
        codes = [kernels._blockwise_quant_pass(b[0], bk)[0] for b in bufs]
        out[f"{label} torch._int_mm"] = cs.graph_ms(
            lambda: torch._int_mm(codes[next(it) % 4], bufs[0][1]), 20)
        del bufs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another tree's csrc (an earlier design)")
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), help="these keys only")
    ap.add_argument("--variant", nargs="+", help="variants whose label holds one of these")
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
            if args.only and name not in args.only:
                continue
            if args.baseline:
                variants = variants + [("baseline", [])]
            for i, (label, edits) in enumerate(variants):
                if args.variant and not any(v in label for v in args.variant):
                    continue
                where = Path(tmp) / f"{name.replace('/', '-')}-{i}"
                where.mkdir()
                shipped = kernels.CSRC
                if label == "baseline":
                    kernels.CSRC = args.baseline.resolve()
                try:
                    builds.append((name, label, edits, *tune_attention_loops.start_build(
                        name.split("/")[0], edits, where)))
                finally:
                    kernels.CSRC = shipped
        for name, label, edits, proc, lib in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name} {label}: nvcc failed\n{log}")
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
            use_library(name.split("/")[0], lib)
            gen = torch.Generator(device="cuda").manual_seed(0)
            if name == "qmm_res_ln":
                res = time_qmm(gen)
            elif name == "w4a16_matmul":
                res = time_w4(gen)
            elif name == "quant_matmul_blockwise":
                res = time_blockwise(gen, not label.startswith("diagnostic"))
            elif name == "w4_unpack_matmul/decode":
                res = time_unpack_decode(gen, not label.startswith("diagnostic"))
            elif name in ("w4v3_matmul/decode", "w8p_matmul/decode"):
                res = time_probe_decode(gen, not label.startswith("diagnostic"),
                                        name.split("/")[0])
            else:
                res = time_w4_decode(gen, not label.startswith("diagnostic"))
            lines.append(json.dumps({"kernel": name, "variant": label, "registers": regs, **res}))
            print(lines[-1], flush=True)
    lines.append(cs.smi_line())
    print(lines[-1])
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
