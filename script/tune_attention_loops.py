#!/usr/bin/env python3
"""Time variants of the packed-qkv loop (#1) and the flash forward loop
(#4, #7) on one CUDA card, each held to its plain version first.

    python3 script/tune_attention_loops.py [--out FILE]

A variant is the shipped source with some of its tile constants changed:
the script copies stllm_tpu_torch/csrc into a temporary directory, rewrites
the constants there (the checkout is not touched), builds the variant's
library with nvcc as ops/kernels.py builds it, and swaps it in for the
kernel's own. Shapes: #1 at the ViT-g trunk (16, 257, 16, 88) and the
BTAdapter temporal shape (256, 16, 16, 88); #4 at (1, 1024, 32, 128) causal
with a padded kv_mask; #7 at (1, 768, 32, 128), causal, padded. Times are
CUDA-graph replays cycling four input copies (chip_smoke.graph_ms), beside
SDPA on the same inputs. Prints one JSON line per variant and the card's
name and power limit.
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
FLASH = "flash_attention.cuh"


def _warps(n):
    return (PACKED, r"constexpr int kMaxWarps = \d+;", f"constexpr int kMaxWarps = {n};")


def _packed_min_blocks(n):
    return (PACKED, r"__launch_bounds__\(kMaxThreads, 2\)", f"__launch_bounds__(kMaxThreads, {n})")


def _flash_min_blocks(n):
    return (FLASH, r"__launch_bounds__\(kThreads, 3\) flash_fwd_kernel",
            f"__launch_bounds__(kThreads, {n}) flash_fwd_kernel")


def _keys(n):
    return (PACKED, r"constexpr int kLongKeys = \d+;", f"constexpr int kLongKeys = {n};")


def _stages(n):
    return (PACKED, r"constexpr int kStages = \d+;", f"constexpr int kStages = {n};")


def _fwd_keys(n):
    return (FLASH, r"constexpr int kFwdTile = \d+;", f"constexpr int kFwdTile = {n};")


VARIANTS = {
    "packed_qkv_attention": [
        ("shipped", []),
        ("16 keys", [_keys(16)]),
        ("3 stages", [_stages(3)]),
        ("warps 6, 3 blocks", [_warps(6), _packed_min_blocks(3)]),
        ("warps 17, 1 block", [_warps(17), _packed_min_blocks(1)]),
    ],
    "flash_attention_fwd": [
        ("shipped", []),
        ("2 blocks", [_flash_min_blocks(2)]),
        ("32 keys", [_fwd_keys(32)]),
        ("32 keys, 4 blocks", [_fwd_keys(32), _flash_min_blocks(4)]),
    ],
}


def start_build(name: str, edits, tmp: Path):
    """Copy the sources to ``tmp``, apply ``edits`` and start nvcc on the
    kernel's file; returns (the running nvcc, the library it writes)."""
    from stllm_tpu_torch.ops import kernels

    src = tmp / "csrc"
    shutil.copytree(kernels.CSRC, src)
    for header, pattern, repl in edits:
        path = src / header
        text, n = re.subn(pattern, repl, path.read_text())
        if n != 1:
            raise RuntimeError(f"{header}: {pattern!r} matched {n} times")
        path.write_text(text)
    lib = tmp / f"lib{name}.so"
    cmd = [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib),
           str(src / kernels.SOURCES[name])]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the lines to this file")
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
            for i, (label, edits) in enumerate(variants):
                where = Path(tmp) / f"{name}-{i}"
                where.mkdir()
                builds.append((name, label, *start_build(name, edits, where)))
        for name, label, proc, lib in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name} {label}: nvcc failed\n{log}")
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
            use_library(name, lib)
            gen = torch.Generator(device="cuda").manual_seed(0)
            res = time_packed(gen) if name == "packed_qkv_attention" else time_flash(gen)
            lines.append(json.dumps({"kernel": name, "variant": label, "registers": regs, **res}))
            print(lines[-1], flush=True)
    lines.append(cs.smi_line())
    print(lines[-1])
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
