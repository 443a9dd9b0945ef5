#!/usr/bin/env python3
"""Instructions a packed byte of the weight-streaming decode form
(csrc/w4a16_decode.cuh), by the byte's meaning: kNibble (#12's int4
nibbles), kArith (#13's arithmetic packing), kInt8 (#14's int8 codes) and
the five unpack variants of the probe #15 (kProbeInt32 ... kProbeAnd8),
counted in the SASS of the built libraries.

    python3 script/decode_sass.py [--rows 8|16]

Run from the repository root on a machine with the CUDA toolkit (nvcc,
cuobjdump) and a card (for its name and power limit). It builds
``w4a16_matmul``, ``w4v3_matmul``, ``w8p_matmul`` and ``w4_unpack_matmul``
as ``ops/kernels.py`` builds them, disassembles each library with ``cuobjdump -sass`` and, in
the decode kernel of each mode at one n8 tile of x rows (M <= 8) or two
(``--rows 16``), finds the main loop: the backward branch whose span holds
the most tensor-core products (HMMA), the shortest such. A warp runs that
span once a 16-row step; each lane then holds 4 rows x 16 bytes of the
step, so

    thread instructions a packed byte = span / 64

(an int4 byte carries two weights, an int8 byte one). The span is counted
by class (the products, shared-memory reads, cp.async copies, and the
integer and floating-point unpack with the rest) and by opcode. Prints one
JSON line per mode and one with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "script"))

from row_quant_sass import functions  # noqa: E402

MODES = [("kNibble", "w4a16_matmul", 0, 2), ("kArith", "w4v3_matmul", 1, 2),
         ("kInt8", "w8p_matmul", 2, 1)] + [      # (mode, library, wsm::Mode, halves of x)
    (f"kProbe{v.capitalize()}", "w4_unpack_matmul", 3 + i, 2)
    for i, v in enumerate(("int32", "int16", "f32", "bf16", "and8"))]
BYTES_A_LANE_A_STEP = 4 * 16
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
CLASSES = {"products": {"HMMA"}, "shared reads": {"LDS", "LDSM"},
           "copies": {"LDGSTS", "LDGDEPBAR", "DEPBAR"},
           "fp32 and bf16 arithmetic": {"FADD", "FFMA", "FMUL", "HFMA2", "HADD2", "HMUL2", "F2FP",
                                        "F2F", "I2F", "FRND"},
           "integer and byte": {"LOP3", "PRMT", "SHF", "IADD3", "IMAD", "LEA", "ISETP", "SEL",
                                "IMNMX", "MOV"}}


def main_loop(lines) -> list:
    """Opcodes of the span between the target of the backward branch whose
    span holds the most HMMA (the shortest such) and that branch."""
    insns = []
    for line in lines:
        m = _LINE.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
    best = None
    for i, (addr, op, rest) in enumerate(insns):
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op != "BRA" or not t or int(t.group(1), 16) >= addr:
            continue
        start = int(t.group(1), 16)
        span = [o for a, o, _ in insns if start <= a <= addr]
        key = (span.count("HMMA"), -len(span))
        if best is None or key > best[0]:
            best = (key, span)
    if best is None or not best[0][0]:
        raise SystemExit("no loop with HMMA found")
    return best[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8, choices=(8, 16),
                    help="rows of x the instance takes (one or two n8 tiles)")
    args = ap.parse_args()
    import torch

    from stllm_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("decode_sass: no CUDA device", file=sys.stderr)
        return 1
    mt = args.rows // 8
    bindir = Path(kernels._nvcc()).parent
    cuobjdump = shutil.which("cuobjdump") or str(bindir / "cuobjdump")
    demangler = shutil.which("cu++filt") or (str(bindir / "cu++filt") if (
        bindir / "cu++filt").exists() else "c++filt")
    kernels.build(sorted({lib for _, lib, _, _ in MODES}))
    out = {}
    for mode, lib, code, halves in MODES:
        sass = functions(subprocess.run([cuobjdump, "-sass", str(kernels._lib_path(lib))],
                                        capture_output=True, text=True, check=True).stdout,
                         demangler)
        head = f"w4_decode_kernel<{code}, {mt}>("
        found = [f for f in sass if head in re.sub(r"\((?:int|bool)\)", "", f)]
        if len(found) != 1:
            raise SystemExit(f"{mode}: {len(found)} functions match {head}")
        span = main_loop(sass[found[0]])
        steps = span.count("HMMA") // (8 * halves * mt)   # products a step: 8 tiles x halves x MT
        if steps < 1 or span.count("HMMA") % (8 * halves * mt):
            raise SystemExit(f"{mode}: {span.count('HMMA')} HMMA in the loop")
        per = BYTES_A_LANE_A_STEP * steps
        ops = Counter(span)
        classes = {c: sum(ops[o] for o in members) for c, members in CLASSES.items()}
        classes["other"] = len(span) - sum(classes.values())
        out[mode] = {"function": found[0], "steps_a_pass": steps, "loop_instructions": len(span),
                     "per_packed_byte": len(span) / per,
                     "per_packed_byte_by_class": {c: n / per for c, n in classes.items()},
                     "opcodes": dict(ops.most_common())}
        print(json.dumps({"mode": mode, "rows": args.rows, **out[mode]}))
    import chip_smoke as cs

    print(json.dumps({"card": cs.smi_line(), "per_packed_byte": {
        m: round(v["per_packed_byte"], 3) for m, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
