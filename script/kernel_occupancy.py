#!/usr/bin/env python3
"""Blocks per SM of the packed-qkv attention (#1), the flash forward (#4),
both forms of the W4A16 matmul (#12: the wgmma prefill form, the tile loop
at 64 and 16 rows) and both forms of the fused
LayerNorm int8 GEMM (#11 at the ViT-g width N = 1408, M = 16 x 257: the
cluster form's blocks per SM and the clusters of 8 the card holds at once,
the 16-row kernel's blocks per SM) on the current CUDA card, by
cudaOccupancyMaxActiveBlocksPerMultiprocessor and
cudaOccupancyMaxActiveClusters.

    python3 script/kernel_occupancy.py                  # this tree's kernels
    python3 script/kernel_occupancy.py --csrc OTHER/stllm_tpu_torch/csrc

Without ``--csrc`` it asks the kernels' own entry points (#1 at the ViT-g
trunk shape S = 257 and the BTAdapter temporal S = 16, D = 88; #4 at
D = 128; #12 and #11 as above). With ``--csrc`` it builds a small shim against another tree's
headers of the earlier design (``packed_qkv_attention_kernel<96>`` with 128
threads and static shared memory, ``flash::flash_fwd_kernel<128, false>``
with its dynamic shared memory), so the two designs can be read side by side
on one card. Prints one JSON line with the card's name and power limit.
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

SHIM = r"""
#include "flash_attention.cuh"
#include "packed_qkv_attention.cuh"

extern "C" int occ_packed() {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, stllm::packed_qkv_attention_kernel<96, __nv_bfloat16>, 128, 0);
  return n;
}

extern "C" int occ_flash() {
  auto k = stllm::flash::flash_fwd_kernel<128, false>;
  const int smem = stllm::flash::fwd_smem_bytes<128>();
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 128, smem);
  return n;
}
"""


def earlier_design(csrc: Path) -> dict:
    from stllm_tpu_torch.ops.kernels import _nvcc

    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "occupancy.cu", Path(tmp) / "libocc.so"
        src.write_text(SHIM)
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", f"-I{csrc}", "-o", str(lib),
                        str(src)], check=True)
        so = ctypes.CDLL(str(lib))
        return {"packed_qkv_attention": {"S=257": so.occ_packed(), "S=16": so.occ_packed()},
                "flash_attention_fwd": so.occ_flash()}


def this_design() -> dict:
    from stllm_tpu_torch.ops import kernels

    m, n = 16 * 257, 1408
    return {"packed_qkv_attention": {f"S={s}": kernels.occupancy("packed_qkv_attention", s, 88)
                                     for s in (257, 16)},
            "flash_attention_fwd": kernels.occupancy("flash_attention_fwd", 128),
            "w4a16_matmul": {"wgmma": kernels.occupancy("w4a16_matmul", 1, 0),
                             "tile loop BM=64": kernels.occupancy("w4a16_matmul", 0, 64),
                             "tile loop BM=16": kernels.occupancy("w4a16_matmul", 0, 16)},
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
    blocks = earlier_design(args.csrc.resolve()) if args.csrc else this_design()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"csrc": str(args.csrc or "this tree"), "blocks_per_sm": blocks,
                      "card": smi.splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
