#!/usr/bin/env python3
"""Blocks per SM of the packed-qkv attention (#1) and its static-int8 ring
loop (#3), the row kernels' register form (#9 LayerNorm -> int8, #10 GELU
-> int8 at K = 1408 and 6144, bf16 and fp32, with registers a thread), the
flash forward (#4),
the flash backward pair (#5 dQ, #6 dK/dV),
both forms of the W4A16 matmul (#12: the wgmma prefill form, the tile loop
at 64 and 16 rows) and both forms of the fused
LayerNorm int8 GEMM (#11 at the ViT-g width N = 1408, M = 16 x 257: the
cluster form's blocks per SM and the clusters of 8 the card holds at once,
the 16-row kernel's blocks per SM) and the blockwise dynamic W8A8 matmul
(#8 at its fc1 and fc2 shapes: the GEMM's blocks per SM, registers and
tile width, the quant pass's blocks per SM and registers) on the current
CUDA card, by
cudaOccupancyMaxActiveBlocksPerMultiprocessor and
cudaOccupancyMaxActiveClusters.

    python3 script/kernel_occupancy.py                  # this tree's kernels
    python3 script/kernel_occupancy.py --csrc OTHER/stllm_tpu_torch/csrc   # and another's

It asks the kernels' own entry points (#1 and #3 at the ViT-g trunk shape S = 257
and the BTAdapter temporal S = 16, D = 88; #4, #5 and #6 at D = 128; #12
and #11 as above). With ``--csrc`` it also builds small shims against
another tree's headers of the earlier designs (``packed_qkv_attention_kernel
<96>`` with 128 threads and static shared memory; ``flash::flash_fwd_kernel
<128, false>``, ``flash::flash_bwd_dq_kernel<128>`` and ``flash::
flash_bwd_dkv_kernel<128>`` with their dynamic shared memory), one shim a
kernel, so the two designs can be read side by side on one card; a kernel
the other tree does not have under that name reads null. Prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_FLASH_SHIM = r"""
#include "flash_attention.cuh"

extern "C" int occ() {
  auto k = stllm::flash::%s<128%s>;
  const int smem = stllm::flash::%s<128>();
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 128, smem);
  return n;
}
"""
SHIMS = {
    "packed_qkv_attention": r"""
#include "packed_qkv_attention.cuh"

extern "C" int occ() {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, stllm::packed_qkv_attention_kernel<96, __nv_bfloat16>, 128, 0);
  return n;
}
""",
    "flash_attention_fwd": _FLASH_SHIM % ("flash_fwd_kernel", ", false", "fwd_smem_bytes"),
    "flash_attention_bwd_dq": _FLASH_SHIM % ("flash_bwd_dq_kernel", "", "dq_smem_bytes"),
    "flash_attention_bwd_dkv": _FLASH_SHIM % ("flash_bwd_dkv_kernel", "", "dkv_smem_bytes"),
}


def earlier_design(csrc: Path) -> dict:
    """Blocks per SM of each shim's kernel built against ``csrc`` (null
    where that tree has no such kernel)."""
    from stllm_tpu_torch.ops.kernels import _nvcc

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        running = []
        for name, shim in SHIMS.items():
            src, lib = Path(tmp) / f"{name}.cu", Path(tmp) / f"lib{name}.so"
            src.write_text(shim)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", f"-I{csrc}", "-o", str(lib), str(src)]
            running.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                                        stderr=subprocess.DEVNULL)))
        for name, lib, proc in running:
            out[name] = ctypes.CDLL(str(lib)).occ() if proc.wait() == 0 else None
    out["packed_qkv_attention"] = {"S=257": out["packed_qkv_attention"],
                                   "S=16": out["packed_qkv_attention"]}
    return out


def this_design() -> dict:
    from stllm_tpu_torch.ops import kernels

    m, n = 16 * 257, 1408
    return {"packed_qkv_attention": {f"S={s}": kernels.occupancy("packed_qkv_attention", s, 88)
                                     for s in (257, 16)},
            "packed_qkv_attention_s8": {
                f"S={s}": kernels.occupancy("packed_qkv_attention_s8", s, 88) for s in (257, 16)},
            **{name: {f"K={k} {dt}": {"blocks_per_sm": kernels.occupancy(name, k, f32, 0),
                                       "registers": kernels.occupancy(name, k, f32, 1)}
                      for k in (1408, 6144) for f32, dt in ((0, "bf16"), (1, "fp32"))}
               for name in ("layer_norm_quant", "gelu_quant")},
            "flash_attention_fwd": kernels.occupancy("flash_attention_fwd", 128),
            "flash_attention_bwd_dq": kernels.occupancy("flash_attention_bwd_dq", 128),
            "flash_attention_bwd_dkv": kernels.occupancy("flash_attention_bwd_dkv", 128),
            "w4a16_matmul": {"wgmma": kernels.occupancy("w4a16_matmul", 1, 0),
                             "decode M<=8": kernels.occupancy("w4a16_matmul", 2, 8),
                             "decode M<=16": kernels.occupancy("w4a16_matmul", 2, 16),
                             "tile loop BM=64": kernels.occupancy("w4a16_matmul", 0, 64),
                             "tile loop BM=16": kernels.occupancy("w4a16_matmul", 0, 16)},
            "quant_matmul_blockwise": {
                label: {"gemm": {what: kernels.occupancy("quant_matmul_blockwise", m, k, nn, bk, 0,
                                                         code)
                                 for what, code in (("blocks_per_sm", 0), ("registers", 1),
                                                    ("tile_columns", 2))},
                        "quant_pass": {what: kernels.occupancy("quant_matmul_blockwise", m, k, nn,
                                                               bk, 0, code)
                                       for what, code in (("blocks_per_sm", 3),
                                                          ("registers", 4))}}
                for label, k, nn, bk in (("fc1", 1408, 6144, 1408), ("fc2", 6144, 1408, 2048))},
            "qmm_res_ln": {"cluster, blocks per SM": kernels.occupancy("qmm_res_ln", 1, 0, m, n),
                           "cluster, clusters on the card":
                               kernels.occupancy("qmm_res_ln", 1, 1, m, n),
                           "16-row kernel, blocks per SM":
                               kernels.occupancy("qmm_res_ln", 0, 0, m, n)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, help="another tree's csrc (the earlier design)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_occupancy: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.init()
    blocks = {"this tree": this_design()}
    if args.csrc:
        blocks[f"earlier design ({args.csrc})"] = earlier_design(args.csrc.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"blocks_per_sm": blocks, "card": smi.splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
