#!/usr/bin/env python3
"""Time variants of the packed-qkv loop (#1), its static-int8 ring loop
(#3), the flash forward loop (#4, #7), the flash backward pair (#5 dQ,
#6 dK/dV) and the row kernels' register form (#9 LayerNorm -> int8, #10
GELU -> int8) on one CUDA card, each held to its plain version first.

    python3 script/tune_attention_loops.py [--only KERNEL ...] [--parent CSRC] [--out FILE]

A variant is the shipped source with some of its tile constants changed:
the script copies stllm_tpu_torch/csrc into a temporary directory, rewrites
the constants there (the checkout is not touched), builds the variant's
library with nvcc as ops/kernels.py builds it, and swaps it in for the
kernel's own. Shapes: #1 at the ViT-g trunk (16, 257, 16, 88) and the
BTAdapter temporal shape (256, 16, 16, 88); #3 at the trunk and the ragged
(3, 37, 4, 88), on static-int8 qkv, its whole call (the ring loop and the
row-quant pass); #9 at the trunk's 16 x 257 bf16 rows of 1408, #10 at its
rows of 6144, erf and tanh; #4 at (1, 1024, 32, 128) causal
with a padded kv_mask; #7 at (1, 768, 32, 128), causal, padded; #5 and
#6 at (1, 1024, 32, 128) causal with a padded kv_mask, beside SDPA's whole
backward on the same inputs, device time only (chip_smoke.queued_ms). The
backward variants are the walked tile's width, dQ's stage depth and score
sub-tile, the rows a block owns and the blocks per SM, and the earlier
launch order (row tile fastest, ascending); the row kernels' are the
divide by __fdiv_rn in place of the row's reciprocal and blocks per SM;
``--parent`` adds "parent", #3
and each backward kernel built from another tree's csrc (the earlier
design, timed in the same call). Variants labelled "diagnostic" drop work and are timed without the
check. ``--only`` keeps the named kernels' variants. Times are
CUDA-graph replays cycling four input copies (chip_smoke.graph_ms), beside
SDPA on the same inputs. Prints one JSON line per variant (with ptxas's
registers and spill bytes) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# an edit: (header, pattern that must match once, replacement)
PACKED = "packed_qkv_attention.cuh"
S8 = "packed_qkv_attention_s8.cu"
FLASH = "flash_attention.cuh"
ROWS = "rowwise_quant.cuh"
GELU = "gelu_quant.cu"
# the row kernels' divide of every code by __fdiv_rn (the same codes, as
# before the row's reciprocal took its place), or by the product with the
# reciprocal alone (wrong codes: a diagnostic of the divide's share)
_FDIV_RN = (ROWS, r"if \(s >= kDivMin && s <= kDivMax\) \{", "if (false) {")
_NO_DIVIDE = (ROWS, r"rintf\(div_rn_by\(v, s, r\)\)", "rintf(v * r)")


def _warps(n):
    return (PACKED, r"constexpr int kMaxWarps = \d+;", f"constexpr int kMaxWarps = {n};")


def _packed_min_blocks(n):
    return (PACKED, r"__launch_bounds__\(kMaxThreads, 2\)", f"__launch_bounds__(kMaxThreads, {n})")


def _s8_min_blocks(n):
    return (S8, r"__launch_bounds__\(kMaxThreads, 2\)", f"__launch_bounds__(kMaxThreads, {n})")


def _s8_stages(n):
    return (S8, r"constexpr int kS8Stages = \d+;", f"constexpr int kS8Stages = {n};")


# diagnostics (timed without the check): the ring loop's loads, conversions,
# barriers and stores with no products; the attention launch without the
# row-quant pass
_S8_NO_PRODUCTS = (S8, r"    if \(active\) \{\n      const int k0 = i \* BK;",
                   "    if (active && S < 0) {\n      const int k0 = i * BK;")
_S8_NO_ROW_QUANT = (S8, r"(launch_s8\([^;]*;\n\s*if \(err != cudaSuccess\) return "
                        r"static_cast<int>\(err\);\n\s*)return static_cast<int>\(quantize"
                        r"\(rows, out_q, out_scale, B, S, H, D, st\)\);",
                    r"\1return 0;")


def _flash_min_blocks(n):
    return (FLASH, r"__launch_bounds__\(kThreads, 3\) flash_fwd_kernel",
            f"__launch_bounds__(kThreads, {n}) flash_fwd_kernel")


def _keys(n):
    return (PACKED, r"constexpr int kLongKeys = \d+;", f"constexpr int kLongKeys = {n};")


def _stages(n):
    return (PACKED, r"constexpr int kStages = \d+;", f"constexpr int kStages = {n};")


def _fwd_keys(n):
    return (FLASH, r"constexpr int kFwdTile = \d+;", f"constexpr int kFwdTile = {n};")


def _bwd_const(name, n):
    return (FLASH, rf"constexpr int {name} = \d+;", f"constexpr int {name} = {n};")


def _bwd_min_blocks(kernel, n):
    return (FLASH, rf"__launch_bounds__\(2 \* ROWS, 128 / ROWS\) {kernel}",
            f"__launch_bounds__(2 * ROWS, {n}) {kernel}")


def _row_tile_fastest(first_use):
    """The earlier launch order: the block's row tile fastest and in
    ascending order, (head, batch) slowest."""
    return [(FLASH, r"const int tile = blockIdx.x / bh_count;\n  const int bh = blockIdx.x % "
                    rf"bh_count;\n(  const int {first_use})",
             "const int n_tiles_ = gridDim.x / bh_count;\n  const int tile = blockIdx.x % "
             "n_tiles_;\n  const int bh = blockIdx.x / n_tiles_;\n\\1")] + (
        [(FLASH, r"\(p\.causal \? n_q - 1 - tile : tile\) \* ROWS", "tile * ROWS")]
        if first_use == "q0" else [])


VARIANTS = {
    "packed_qkv_attention": [
        ("shipped", []),
        ("16 keys", [_keys(16)]),
        ("3 stages", [_stages(3)]),
        ("warps 6, 3 blocks", [_warps(6), _packed_min_blocks(3)]),
        ("warps 17, 1 block", [_warps(17), _packed_min_blocks(1)]),
    ],
    "packed_qkv_attention_s8": [
        ("shipped", []),
        ("16 keys", [_keys(16)]),
        ("64 keys", [_keys(64)]),
        ("2 stages", [_s8_stages(2)]),
        ("4 stages", [_s8_stages(4)]),
        ("warps 6, 3 blocks", [_warps(6), _s8_min_blocks(3)]),
        ("diagnostic: no products", [_S8_NO_PRODUCTS]),
        ("diagnostic: attention launch alone", [_S8_NO_ROW_QUANT]),
    ],
    "flash_attention_fwd": [
        ("shipped", []),
        ("2 blocks", [_flash_min_blocks(2)]),
        ("32 keys", [_fwd_keys(32)]),
        ("32 keys, 4 blocks", [_fwd_keys(32), _flash_min_blocks(4)]),
    ],
    "flash_attention_bwd_dq": [
        ("shipped", []),
        ("32-key tile", [_bwd_const("kDqTile", 32)]),
        ("32-key tile, row tile fastest (step 1)",
         [_bwd_const("kDqTile", 32), *_row_tile_fastest("q0")]),
        ("row tile fastest (step 2)", _row_tile_fastest("q0")),
        ("3 stages", [_bwd_const("kDqStages", 3)]),
        ("64-key sub-tile", [_bwd_const("kDqSub", 64)]),
        ("128 rows", [_bwd_const("kDqRows", 128)]),
        ("3 blocks", [_bwd_min_blocks("flash_bwd_dq_kernel", 3)]),
    ],
    "flash_attention_bwd_dkv": [
        ("shipped", []),
        ("64 rows (one warpgroup, 2 blocks)", [_bwd_const("kDkvRows", 64)]),
        ("32-query tile", [_bwd_const("kDkvTile", 32)]),
        ("row tile fastest", _row_tile_fastest("kbase")),
    ],
    "layer_norm_quant": [
        ("shipped", []),
        ("divide by __fdiv_rn", [_FDIV_RN]),
        ("4 blocks an SM (at most 64 registers)",
         [("layer_norm_quant.cu", r"__launch_bounds__\(kRegThreads\)\nlayer_norm_quant_regs",
           "__launch_bounds__(kRegThreads, 4)\nlayer_norm_quant_regs")]),
        ("diagnostic: no divide", [_NO_DIVIDE]),
    ],
    "gelu_quant": [
        ("shipped", []),
        ("divide by __fdiv_rn", [_FDIV_RN]),
        ("diagnostic: no divide", [_NO_DIVIDE]),
        ("diagnostic: no erf or tanh",
         [(GELU, r"inner = tanhf\(", "inner = ("), (GELU, r"inner = erff\(", "inner = (")]),
        ("diagnostic: no GELU, no divide",
         [_NO_DIVIDE, (GELU, r"const float y = gelu\(v\[l \* kVec \+ j\], kApprox\);",
                       "const float y = v[l * kVec + j];")]),
    ],
}
ROW_KERNELS = ("layer_norm_quant", "gelu_quant")
BACKWARD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
WITH_PARENT = ("packed_qkv_attention_s8", *BACKWARD)   # the kernels --parent adds


def start_build(name: str, edits, tmp: Path, csrc: Path = None):
    """Copy the sources (``csrc``, default this tree's) to ``tmp``, apply
    ``edits`` and start nvcc on the kernel's file; returns (the running
    nvcc, the library it writes)."""
    from stllm_tpu_torch.ops import kernels

    src = tmp / "csrc"
    shutil.copytree(csrc or kernels.CSRC, src)
    for header, pattern, repl in edits:
        path = src / header
        text, n = re.subn(pattern, repl, path.read_text())
        if n != 1:
            raise RuntimeError(f"{header}: {pattern!r} matched {n} times")
        path.write_text(text)
    lib = tmp / f"lib{name}.so"
    cmd = kernels.nvcc_command(src / kernels.SOURCES[name], lib)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def use_library(name: str, lib: Path) -> None:
    """Make ops/kernels.py launch ``name`` from ``lib``."""
    from stllm_tpu_torch.ops import kernels

    kernels._LIBS[name] = ctypes.CDLL(str(lib))
    for symbol in [kernels._ENTRY[name][0], kernels._F32_SYMBOLS.get(name),
                   kernels._OCCUPANCY.get(name, (None,))[0],
                   *(sym for (kernel, _), (sym, _) in kernels._FORM_ENTRY.items()
                     if kernel == name)]:
        kernels._FNS.pop(symbol, None)


def time_packed(gen) -> dict:
    import torch.nn.functional as F

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for label, shape in (("trunk", cs.TRUNK), ("temporal", cs.TEMPORAL)):
        b, s, h, d = shape
        bufs = cs._qkv_bufs(gen, b, s, h, d)
        cs._bf16_err(kernels.packed_qkv_attention(bufs[0], h, d, d ** -0.5),
                     kernels.packed_qkv_attention_plain(bufs[0], h, d, d ** -0.5))
        it = iter(range(1 << 30))

        def sdpa(qkv):
            q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2))

        out[label] = {
            "ms": cs.graph_ms(lambda: kernels.packed_qkv_attention(
                bufs[next(it) % 4], h, d, d ** -0.5), 40),
            "sdpa_ms": cs.graph_ms(lambda: sdpa(bufs[next(it) % 4]), 40),
            "blocks_per_sm": kernels.occupancy("packed_qkv_attention", s, d)}
    return out


def time_s8(gen, check: bool = True) -> dict:
    """#3's whole call (ring loop and row-quant pass) on static-int8 qkv,
    held to its plain version first (a diagnostic variant is not)."""
    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for label, shape in (("trunk", cs.TRUNK), ("ragged", (3, 37, 4, 88))):
        b, s, h, d = shape
        bufs = [(*cs._static_int8(q), h, d, d ** -0.5) for q in cs._qkv_bufs(gen, b, s, h, d)]
        if check:
            cs._int8_err(kernels.packed_qkv_attention_s8(*bufs[0]),
                         kernels.packed_qkv_attention_s8_plain(*bufs[0]))
        it = iter(range(1 << 30))
        out[label] = {"ms": cs.graph_ms(lambda: kernels.packed_qkv_attention_s8(
            *bufs[next(it) % 4]), 40)}
    try:
        out["blocks_per_sm"] = kernels.occupancy("packed_qkv_attention_s8", cs.TRUNK[1], 88)
    except AttributeError:          # a tree whose library has no occupancy entry
        out["blocks_per_sm"] = None
    return out


def time_rows(name: str, gen, check: bool = True) -> dict:
    """#9 or #10 (erf and tanh) at the trunk's bf16 rows, held to its plain
    version first (a diagnostic variant is not)."""
    import torch

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    bf16, kernel = torch.bfloat16, getattr(kernels, name)
    if name == "layer_norm_quant":
        calls = {"": [cs._row_input(gen, (16, 257, 1408), bf16, bf16) for _ in range(4)]}
    else:
        xs = [cs._row_input(gen, (16, 257, 6144), bf16, None)[0] for _ in range(4)]
        calls = {"_erf": [(x, False) for x in xs], "_tanh": [(x, True) for x in xs]}
    out = {}
    for form, bufs in calls.items():
        if check:
            cs._row_err(kernel(*bufs[0]), getattr(kernels, name + "_plain")(*bufs[0]))
        it = iter(range(1 << 30))
        out["ms" + form] = cs.graph_ms(lambda: kernel(*bufs[next(it) % 4]), 40)
    return out


def time_flash(gen) -> dict:
    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    out = {}
    for label, fn, plain, shape in (
            ("flash 1024", kernels.flash_attention_fwd, kernels.flash_attention_fwd_plain,
             cs.TRAIN_LONG),
            ("fused 768", kernels.fused_short_attention, kernels.fused_short_attention_plain,
             cs.TRAIN_SHORT)):
        bufs, _ = cs._attn_case(gen, shape, True, True)
        got, want = fn(*bufs[0]), plain(*bufs[0])
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        cs._bf16_err(got, want)
        it = iter(range(1 << 30))
        out[label] = {"ms": cs.graph_ms(lambda: fn(*bufs[next(it) % 4]), 40)}
    out["blocks_per_sm"] = kernels.occupancy("flash_attention_fwd", cs.TRAIN_LONG[3])
    return out


_SDPA_BWD = {}


def time_backward(name: str, gen) -> dict:
    """#5 or #6 at the training shape, held to the plain backward first;
    SDPA's whole backward on the same inputs, device time only, once a
    call."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from stllm_tpu_torch.ops import kernels

    b, s, h, d = cs.TRAIN_LONG
    bufs, masks = cs._attn_case(gen, cs.TRAIN_LONG, True, True)
    args = []
    for q, k, v, kv_mask, causal, scale in bufs:
        o, lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
        g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args.append((q, k, v, kv_mask, g, lse, delta, causal, scale))
    fn = getattr(kernels, name)
    got, want = fn(*args[0]), kernels.flash_attention_bwd_plain(*args[0])
    pairs = zip([got], want[:1]) if name == "flash_attention_bwd_dq" else zip(got, want[1:])
    err = max(cs._bf16_err(a, w) for a, w in pairs)
    it = iter(range(1 << 30))
    out = {"ms": cs.graph_ms(lambda: fn(*args[next(it) % 4]), 40), "max_abs_err": err}
    try:
        out["blocks_per_sm"] = kernels.occupancy(name, d)
    except AttributeError:          # a tree whose library has no occupancy entry
        out["blocks_per_sm"] = None
    if not _SDPA_BWD:
        refs = []
        for q, k, v, kv_mask, g, *_ in args:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in leaves), attn_mask=masks[q.data_ptr()],
                scale=d ** -0.5)
            refs.append((ref, leaves, g.transpose(1, 2)))
        it2 = iter(range(1 << 30))

        def sdpa_backward():
            ref, leaves, g = refs[next(it2) % 4]
            return torch.autograd.grad(ref, leaves, g, retain_graph=True)

        _SDPA_BWD["sdpa_whole_backward_ms"] = cs.queued_ms(sdpa_backward, 40)
    out.update(_SDPA_BWD)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), help="these kernels only")
    ap.add_argument("--parent", type=Path,
                    help="another tree's stllm_tpu_torch/csrc: its #3 and backward pair as "
                         "variants")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("tune_attention_loops: no CUDA device", file=sys.stderr)
        return 1
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = []        # every variant's nvcc at once, one per source
        for name, variants in VARIANTS.items():
            if args.only and name not in args.only:
                continue
            variants = list(variants)
            if args.parent and name in WITH_PARENT:
                variants.append(("parent", None))
            for i, (label, edits) in enumerate(variants):
                where = Path(tmp) / f"{name}-{i}"
                where.mkdir()
                csrc = args.parent.resolve() if edits is None else None
                builds.append((name, label, *start_build(name, edits or [], where, csrc)))
        for name, label, proc, lib in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                for other in builds:
                    other[2].kill()
                raise RuntimeError(f"{name} {label}: nvcc failed\n{log}")
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
            spills = sorted({int(r) for r in re.findall(r"(\d+) bytes spill stores", log)})
            use_library(name, lib)
            gen = torch.Generator(device="cuda").manual_seed(0)
            try:
                if name == "packed_qkv_attention":
                    res = time_packed(gen)
                elif name == "packed_qkv_attention_s8":
                    res = time_s8(gen, not label.startswith("diagnostic"))
                elif name in BACKWARD:
                    res = time_backward(name, gen)
                elif name in ROW_KERNELS:
                    res = time_rows(name, gen, not label.startswith("diagnostic"))
                else:
                    res = time_flash(gen)
            except (AssertionError, RuntimeError) as e:    # wrong, or refused: not timed
                res = {"error": str(e)[:400]}
            lines.append(json.dumps({"kernel": name, "variant": label, "registers": regs,
                                     "spill_store_bytes": spills, **res}))
            print(lines[-1], flush=True)
    lines.append(cs.smi_line())
    print(lines[-1])
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
