#!/usr/bin/env python3
"""Instructions an element of the row kernels' register forms (#9
LayerNorm -> int8, #10 GELU -> int8), counted in the SASS of the built
libraries, and the instruction-issue floors they give at the ViT-g trunk.

    python3 script/row_quant_sass.py [--rows 4112]

Run from the repository root on a machine with the CUDA toolkit (nvcc,
cuobjdump) and a card (for its name, power limit and maximum SM clock). It
builds ``layer_norm_quant`` and ``gelu_quant`` as ``ops/kernels.py`` builds
them, from a copy of the sources whose row quantization keeps only the path
a row with a scale in [2^-64, 2^64] runs (the divide through the row's
reciprocal; every row of a model takes it, and the __fdiv_rn path beside it
would otherwise be counted too), disassembles each library with
``cuobjdump -sass`` and, for the
register-form instance each main-path shape runs (#9: bf16 x, gamma and
beta, K = 1408, one warp a row; #10: bf16, K = 6144, four warps a row, erf
and tanh; and the fp32 instances at the same K), counts the instructions of
the kernel's body up to its last EXIT (the code after it is the IEEE
divide's out-of-line slow path, which runs only for operands near the ends
of the fp32 range) by class. The body is straight-line code (every loop is
unrolled; a chunk past the row is predicated off but still issues), so a
warp issues each of its instructions once per row. Per element:

    thread instructions an element = body x 32 x warps a row / K

and at R rows the issue floor of a class is
R x warps a row x count / (132 SMs x 4 schedulers x clock) (the FP32 pipe
takes one warp instruction a scheduler a cycle; MUFU, at 16 lanes an SM,
one every 8 cycles). The fp32 counts of the bf16 instances are the
operations of chip_smoke.py's bounds (LN_OPS_PER_ELEM, GELU_OPS_PER_ELEM):
the line says whether those still match (``chip_smoke_ops``), and the
script exits 1 where they do not. Prints one JSON line with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SMS, SCHEDULERS, MUFU_CYCLES = 132, 4, 8      # H100 SXM
FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "FSWZADD", "FRND", "F2I",
        "I2F", "F2F", "FSET", "FADD32I", "FMUL32I", "FFMA32I"}
MEMORY = {"LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "LDSM", "ATOMS", "RED"}
CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "WARPSYNC", "SHFL", "NOP",
           "BPT", "YIELD", "DEPBAR"}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
# (label, library, demangled name up to its arguments, K, warps a row)
_BF = "__nv_bfloat16"
INSTANCES = [
    ("layer_norm_quant bf16 K=1408", "layer_norm_quant",
     f"layer_norm_quant_regs<{_BF}, {_BF}, {_BF}, 32, 6>", 1408, 1),
    ("layer_norm_quant fp32 K=1408", "layer_norm_quant",
     "layer_norm_quant_regs<float, float, float, 32, 6>", 1408, 1),
    ("gelu_quant erf bf16 K=6144", "gelu_quant", f"gelu_quant_regs<{_BF}, 128, 6, 0>",
     6144, 4),
    ("gelu_quant tanh bf16 K=6144", "gelu_quant", f"gelu_quant_regs<{_BF}, 128, 6, 1>",
     6144, 4),
    ("gelu_quant erf fp32 K=6144", "gelu_quant", "gelu_quant_regs<float, 128, 6, 0>",
     6144, 4),
]


def functions(sass: str, demangler: str) -> dict:
    """Demangled function name -> its SASS lines."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = subprocess.run([demangler, m.group(1)], capture_output=True, text=True,
                                  check=True).stdout.strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def classify(ops) -> dict:
    c = Counter()
    for op in ops:
        c["all"] += 1
        if op in FP32:
            c["fp32"] += 1
        elif op == "MUFU":
            c["mufu"] += 1
        elif op in MEMORY:
            c["memory"] += 1
        elif op in CONTROL:
            c["control"] += 1
        else:
            c["integer and other"] += 1
    return dict(c)


def count(lines) -> dict:
    ops = [m.group(1) for m in map(_INSN.search, lines) if m]
    last_exit = max(i for i, op in enumerate(ops) if op == "EXIT")
    body, rest = ops[:last_exit + 1], [op for op in ops[last_exit + 1:]
                                       if op not in ("NOP", "BRA")]
    return {"body": classify(body), "out_of_line": len(rest),
            "opcodes": dict(Counter(body).most_common())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16 * 257, help="rows of the floors (the trunk)")
    args = ap.parse_args()
    import torch

    from stllm_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("row_quant_sass: no CUDA device", file=sys.stderr)
        return 1
    bindir = Path(kernels._nvcc()).parent
    cuobjdump = shutil.which("cuobjdump") or str(bindir / "cuobjdump")
    demangler = shutil.which("cu++filt") or (str(bindir / "cu++filt") if (
        bindir / "cu++filt").exists() else "c++filt")
    tmp = Path(tempfile.mkdtemp())
    src = tmp / "csrc"
    shutil.copytree(kernels.CSRC, src)
    header = src / "rowwise_quant.cuh"
    text, n = re.subn(r"if \(s >= kDivMin && s <= kDivMax\) \{", "if (true) {",
                      header.read_text())
    if n != 1:
        raise SystemExit("rowwise_quant.cuh: the divide's range test not found once")
    header.write_text(text)
    libs = {lib: tmp / f"lib{lib}.so" for lib in ("layer_norm_quant", "gelu_quant")}
    for lib, out in libs.items():
        subprocess.run(kernels.nvcc_command(src / kernels.SOURCES[lib], out), check=True,
                       capture_output=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name, power, clock_mhz = [f.strip() for f in smi.split(",")]
    clock = float(clock_mhz) * 1e6
    sass = {lib: functions(subprocess.run([cuobjdump, "-sass", str(libs[lib])],
                                          capture_output=True, text=True, check=True).stdout,
                           demangler)
            for lib in ("layer_norm_quant", "gelu_quant")}
    rows = {}
    for label, lib, head, k, warps in INSTANCES:
        found = [f for f in sass[lib] if head + "(" in re.sub(r"\((?:int|bool)\)", "", f)]
        if len(found) != 1:
            raise SystemExit(f"{label}: {len(found)} functions match {head}: "
                             f"{[f for f in sass[lib] if head.split('<')[0] in f][:4]}")
        c = count(sass[lib][found[0]])
        body = c["body"]
        per_elem = {cls: n * 32 * warps / k for cls, n in body.items()}
        issue = args.rows * warps / (SMS * SCHEDULERS * clock) * 1e3
        rows[label] = {"function": found[0], **c, "thread_instructions_per_element": per_elem,
                       "issue_floor_ms": {"all": body["all"] * issue,
                                          "fp32": body.get("fp32", 0) * issue,
                                          "mufu": body.get("mufu", 0) * MUFU_CYCLES * issue},
                       "byte_floor_ms": args.rows * (k * (2 if "bf16" in label else 4) + k + 4)
                       / 3.35e12 * 1e3}
        print(f"[sass] {label}: {json.dumps(rows[label])}")
    shutil.rmtree(tmp)
    import chip_smoke as cs

    held = {"layer_norm_quant bf16 K=1408": cs.LN_OPS_PER_ELEM,
            "gelu_quant erf bf16 K=6144": cs.GELU_OPS_PER_ELEM[False],
            "gelu_quant tanh bf16 K=6144": cs.GELU_OPS_PER_ELEM[True]}
    ops = {label: {"chip_smoke": v,
                   "counted": round(rows[label]["thread_instructions_per_element"]["fp32"], 2)}
           for label, v in held.items()}
    stale = [label for label, o in ops.items() if abs(o["chip_smoke"] - o["counted"]) > 0.01]
    print(json.dumps({"rows": args.rows, "sm_clock_mhz": float(clock_mhz),
                      "card": f"{name}, {power} W", "chip_smoke_ops": ops,
                      "chip_smoke_ops_stale": stale, "instances": rows}))
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
