"""Hand-written CUDA kernels of the port, their builds and their plain versions.

Each kernel's source is one file under ``stllm_tpu_torch/csrc/`` with a plain
C interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``stllm_tpu_torch/_build/`` (named by a hash of the
source, so an edited source rebuilds) and loaded with ``ctypes``. Every
wrapper launches its kernel on a CUDA tensor, or raises; on a CPU tensor it
runs the kernel's plain PyTorch version, which repeats the kernel's math.
``LAUNCHES`` counts the launches of each kernel.

Kernels (TPU kernel each replaces):
  packed_qkv_attention   stllm_tpu/ops/attention.py:_packed_qkv_kernel
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"packed_qkv_attention": "packed_qkv_attention.cu"}
# C entry points: name -> (symbol, argtypes); every one returns a cudaError_t
_ENTRY = {
    "packed_qkv_attention": (
        "stllm_packed_qkv_attention_bf16",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
BUILD_LOG: Dict[str, str] = {}   # nvcc output (ptxas register/spill report)
_LIBS: Dict[str, ctypes.CDLL] = {}

_EXP2_CLAMP = 50.0
_LOG2E = 1.4426950408889634


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_name(f"{out.name}.log"), "w+")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        running.append((name, subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT),
                        log, tmp, out))
    failed = []
    for name, proc, log, tmp, out in running:
        rc = proc.wait()
        log.seek(0)
        BUILD_LOG[name] = log.read()
        log.close()
        if rc:
            failed.append(f"{name} (nvcc exit {rc}):\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def _entry(name: str):
    """The kernel's C entry point, building and loading its library first."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        symbol, argtypes = _ENTRY[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(lib, _ENTRY[name][0])


# ---------------------------------------------------------------------------
# packed-qkv attention
# ---------------------------------------------------------------------------

def packed_qkv_attention_plain(qkv: torch.Tensor, heads: int, head_dim: int,
                               scale: float) -> torch.Tensor:
    """The kernel's math in plain torch: s = q.k^T * scale * log2(e) in
    fp32, p = exp2(min(s, 50) - 50) with no row max, P cast to the io dtype
    for P.V (fp32 accumulation), divided by sum(p) with a zero guard."""
    b, s, _ = qkv.shape
    q, k, v = (t.reshape(b, s, heads, head_dim).transpose(1, 2).float()
               for t in qkv.chunk(3, dim=-1))
    sc = torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E)
    p = torch.exp2(torch.clamp(sc, max=_EXP2_CLAMP) - _EXP2_CLAMP)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.transpose(1, 2).reshape(b, s, heads * head_dim).to(qkv.dtype)


def packed_qkv_attention(qkv: torch.Tensor, heads: int, head_dim: int,
                         scale: float) -> torch.Tensor:
    """Non-causal attention on packed (B, S, 3*H*D) qkv -> (B, S, H*D).
    CUDA: bf16, contiguous, head_dim a multiple of 8 and at most 112."""
    if qkv.device.type == "cpu":
        return packed_qkv_attention_plain(qkv, heads, head_dim, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_qkv_attention: no kernel for {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"packed_qkv_attention kernel takes bf16, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("packed_qkv_attention kernel takes a contiguous (B, S, 3*H*D) tensor")
    b, s, f = qkv.shape
    if f != 3 * heads * head_dim:
        raise ValueError(f"qkv width {f} != 3 * {heads} * {head_dim}")
    if head_dim % 8 or head_dim > 112 or qkv.data_ptr() % 16:
        raise ValueError(f"packed_qkv_attention kernel: head_dim {head_dim} must be a "
                         "multiple of 8 and at most 112, on a 16-byte aligned buffer")
    out = torch.empty((b, s, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    fn = _entry("packed_qkv_attention")
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), out.data_ptr(), b, s, heads, head_dim,
                 scale * _LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"packed_qkv_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["packed_qkv_attention"] += 1
    return out
