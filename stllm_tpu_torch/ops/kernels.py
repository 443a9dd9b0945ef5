"""Hand-written CUDA kernels of the port, their builds and their plain versions.

Each kernel's source is one file under ``stllm_tpu_torch/csrc/`` with a plain
C interface, plus the ``csrc/*.cuh`` headers it includes. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``stllm_tpu_torch/_build/`` (named by a hash of the source and of every header
it includes, so an edit to either rebuilds) and loaded with ``ctypes``. Every
wrapper launches its kernel on a CUDA tensor, or raises; on a CPU tensor it
runs the kernel's plain PyTorch version, which repeats the kernel's math.
``LAUNCHES`` counts the calls of each kernel's wrapper that launched it.

Kernels (TPU kernel each replaces):
  packed_qkv_attention        stllm_tpu/ops/attention.py:_packed_qkv_kernel
  packed_qkv_attention_quant  stllm_tpu/ops/attention.py:_packed_qkv_quant_kernel
  packed_qkv_attention_s8     stllm_tpu/ops/attention.py:_packed_qkv_s8_kernel
  layer_norm_quant            stllm_tpu/ops/quant.py:_ln_quant_kernel
  gelu_quant                  stllm_tpu/ops/quant.py:_gelu_quant_kernel
  w4a16_matmul                stllm_tpu/ops/quant.py:_w4_pallas_kernel
  w4v3_matmul                 script/probe_decode_budget.py:_w4v3_kernel (probe)
  w8p_matmul                  script/probe_decode_budget.py:_w8p_kernel (probe)
  w4_unpack_matmul            script/probe_w4_unpack.py:kernel (probe)
  fused_short_attention       stllm_tpu/ops/attention.py:_fused_short_kernel
  flash_attention_fwd         stllm_tpu/ops/attention.py:_flash_kernel
  flash_attention_bwd_dq      stllm_tpu/ops/attention.py:_flash_bwd_dq_kernel
  flash_attention_bwd_dkv     stllm_tpu/ops/attention.py:_flash_bwd_dkv_kernel
  qmm_res_ln                  stllm_tpu/ops/quant.py:_qmm_res_ln_kernel
  quant_matmul_blockwise      stllm_tpu/ops/quant.py:_quant_matmul_kernel
The three packed-qkv kernels have two forms (``packed_form``): the tile
loops (``csrc/packed_qkv_attention.cuh``, and #3's ring loop on int8 tiles)
for head_dim a multiple of 8 up to 128, and a simple form
(``csrc/packed_qkv_any.cuh``) for every other head_dim, as the TPU kernels
take any head_dim their feasibility rule admits.
The two row kernels (#9 LayerNorm -> int8, #10 GELU -> int8) take bf16 or
fp32 rows (and #9 bf16 or fp32 gamma and beta, each its own) of any width,
in two forms (``row_quant_form``): the row held in registers by a group of
threads where it is whole 16-byte chunks up to 12288 wide (every model), and
an "any" form, one block a row read element by element, for every other
width.
The four weight-streaming kernels share one tile loop
(``csrc/weight_stream_matmul.cuh``); only the model path launches
``w4a16_matmul``, the probes are launched by their checks and timings.
They take every N and every weight row count the reference takes
(``weight_stream_operands`` pads the rest to multiples of 8).
``w4a16_matmul`` runs two other forms (``w4a16_form``): for M <= 16 rows
one launch with the weight unpacked in registers and K split across a
thread-block cluster (``csrc/w4a16_decode.cuh``), above that a ``wgmma``
mixed-input GEMM with TMA (``csrc/w4a16_prefill.cuh``); the tile loop
stays in the library as the design both replaced. The probes #13 and #14
run that decode form too, on their own bytes, at M <= 16 (``probe_form``)
and the tile loop above; #15 runs it at M <= 8 (``unpack_form``), where
it beats the tile loop, and the tile loop above.
``qmm_res_ln`` has a cluster form for the widths ``qmm_res_ln_form``
admits (thread-block clusters of 8, ``wgmma`` s8, row statistics exchanged
through distributed shared memory); both build on ``csrc/hopper.cuh``. The
four training attention kernels (``csrc/flash_attention.cuh``) are wired
into autograd by ``ops/attention.py``; they take every head_dim in two
forms (``attn_form``): the tile loops up to 128 (a head_dim that is no
multiple of 8 zero-padded to one), and a simple form
(``csrc/flash_attention_any.cuh``) above, as the reference pads any
head_dim to its lane width. The packed-qkv loop and the flash
loops share the copy and fragment helpers of ``csrc/mma_tiles.cuh``. #1, #2
and #4-#7 take bf16 or fp32: an fp32 tensor launches the fp32 entry point of
the same library (``csrc/attention_f32.cuh``, CUDA-core fp32 products) and
counts as a launch of that kernel. ``qmm_res_ln`` runs in the static-int8
ViT under ``STLLM_FUSED_LN``; ``quant_matmul_blockwise`` (#8) is an op of
the surface that no model calls, as in the reference: two launches, a quant
pass that writes each (row, k-block)'s codes and scale once (on the register
form of ``csrc/rowwise_quant.cuh``), then a persistent TMA-fed ``wgmma`` s8
GEMM that folds each k-block's sums with its scales, at any K, N and M.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "packed_qkv_attention": "packed_qkv_attention.cu",
    "packed_qkv_attention_quant": "packed_qkv_attention_quant.cu",
    "packed_qkv_attention_s8": "packed_qkv_attention_s8.cu",
    "layer_norm_quant": "layer_norm_quant.cu",
    "gelu_quant": "gelu_quant.cu",
    "w4a16_matmul": "w4a16_matmul.cu",
    "w4v3_matmul": "w4v3_matmul.cu",
    "w8p_matmul": "w8p_matmul.cu",
    "w4_unpack_matmul": "w4_unpack_matmul.cu",
    "fused_short_attention": "fused_short_attention.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "flash_attention_bwd_dq.cu",
    "flash_attention_bwd_dkv": "flash_attention_bwd_dkv.cu",
    "qmm_res_ln": "qmm_res_ln.cu",
    "quant_matmul_blockwise": "quant_matmul.cu",
}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)   # 12: batch, sequence, head of q, k, v, dO
# C entry points: name -> (symbol, argtypes); every one returns a cudaError_t
_ENTRY = {
    "packed_qkv_attention": (
        "stllm_packed_qkv_attention_bf16", [_P, _P, _I, _I, _I, _I, _F, _P]),
    "packed_qkv_attention_quant": (
        "stllm_packed_qkv_attention_quant_bf16", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "packed_qkv_attention_s8": (
        "stllm_packed_qkv_attention_s8", [_P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P]),
    # x, gamma, beta, q, scale, rows, K, eps, and whether x, gamma, beta are fp32
    "layer_norm_quant": (
        "stllm_layer_norm_quant", [_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _P]),
    # x, q, scale, rows, K, approx, x_f32
    "gelu_quant": ("stllm_gelu_quant", [_P, _P, _P, _LL, _I, _I, _I, _P]),
    # the weight-streaming kernels: x, weights, scale, out, partial, M, N,
    # weight rows in use, splits, out_f32 (#15: the unpack variant)
    **{name: (f"stllm_{name}", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
       for name in ("w4a16_matmul", "w4v3_matmul", "w8p_matmul", "w4_unpack_matmul")},
    # the training attention: q, k, v, (dO,) strides, kv_mask, (lse, delta,)
    # outputs, B, Sq, Sk, H, D, causal, scale
    "fused_short_attention": (
        "stllm_fused_short_attention_bf16",
        [_P, _P, _P, _STRIDES, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attention_fwd": (
        "stllm_flash_attention_fwd_bf16",
        [_P, _P, _P, _STRIDES, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attention_bwd_dq": (
        "stllm_flash_attention_bwd_dq_bf16",
        [_P, _P, _P, _P, _STRIDES, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attention_bwd_dkv": (
        "stllm_flash_attention_bwd_dkv_bf16",
        [_P, _P, _P, _P, _STRIDES, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    # hq, hs, hs_step, w, ws, bias, x_prev, gamma, beta, out_scale, x_new, yq,
    # staged (N > 1536), M, K, N, eps, io_f32
    "qmm_res_ln": (
        "stllm_qmm_res_ln",
        [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
    # x, x_f32, w, ws, codes scratch, scales scratch, out, M, K, N, bk
    "quant_matmul_blockwise": (
        "stllm_quant_matmul", [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

# the second forms' entry points, in the same libraries: (kernel, form) ->
# (symbol, argtypes)
_FORM_ENTRY = {
    # x, packed, scale, out, M, N, K/2, out_f32
    ("w4a16_matmul", "wgmma"): (
        "stllm_w4a16_matmul_prefill", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ("w4a16_matmul", "decode"): (
        "stllm_w4a16_matmul_decode", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # the probes #13, #14 on #12's decode form: x, weights, scale, out, M, N,
    # weight rows in use, out_f32
    ("w4v3_matmul", "decode"): (
        "stllm_w4v3_matmul_decode", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ("w8p_matmul", "decode"): (
        "stllm_w8p_matmul_decode", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # #15 on it: x, packed, no scale, out, M, N, weight rows in use, variant
    ("w4_unpack_matmul", "decode"): (
        "stllm_w4_unpack_matmul_decode", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # the packed kernels' "any" form: the tile loop's arguments, then io_f32
    # (#1, #2); #3's are its tile loop's
    ("packed_qkv_attention", "any"): (
        "stllm_packed_qkv_attention_any", [_P, _P, _I, _I, _I, _I, _F, _I, _P]),
    ("packed_qkv_attention_quant", "any"): (
        "stllm_packed_qkv_attention_quant_any", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    ("packed_qkv_attention_s8", "any"): (
        "stllm_packed_qkv_attention_s8_any", _ENTRY["packed_qkv_attention_s8"][1]),
    # the row kernels' "any" form: the register form's arguments
    ("layer_norm_quant", "any"): (
        "stllm_layer_norm_quant_any", _ENTRY["layer_norm_quant"][1]),
    ("gelu_quant", "any"): ("stllm_gelu_quant_any", _ENTRY["gelu_quant"][1]),
    # the training attention's "any" form: the tile loops' arguments, then
    # io_f32
    **{(name, "any"): (f"stllm_{name}_any", _ENTRY[name][1][:-1] + [_I, _P]) for name in (
        "fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")},
    # qmm_res_ln's arguments without the staged scratch row
    ("qmm_res_ln", "cluster"): (
        "stllm_qmm_res_ln_cluster",
        [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
}

# the fp32-io entry points of the attention kernels (csrc/attention_f32.cuh),
# in the same libraries and with the same arguments as the bf16 ones
_F32_SYMBOLS = {
    "packed_qkv_attention": "stllm_packed_qkv_attention_f32",
    "packed_qkv_attention_quant": "stllm_packed_qkv_attention_quant_f32",
    "fused_short_attention": "stllm_fused_short_attention_f32",
    "flash_attention_fwd": "stllm_flash_attention_fwd_f32",
    "flash_attention_bwd_dq": "stllm_flash_attention_bwd_dq_f32",
    "flash_attention_bwd_dkv": "stllm_flash_attention_bwd_dkv_f32",
}
# resident blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
_OCCUPANCY = {
    "packed_qkv_attention": ("stllm_packed_qkv_attention_occupancy", [_I, _I]),
    "packed_qkv_attention_s8": ("stllm_packed_qkv_attention_s8_occupancy", [_I, _I]),
    "flash_attention_fwd": ("stllm_flash_attention_fwd_occupancy", [_I]),
    "flash_attention_bwd_dq": ("stllm_flash_attention_bwd_dq_occupancy", [_I]),
    "flash_attention_bwd_dkv": ("stllm_flash_attention_bwd_dkv_occupancy", [_I]),
    "w4a16_matmul": ("stllm_w4a16_matmul_occupancy", [_I, _I]),
    "w4v3_matmul": ("stllm_w4v3_matmul_occupancy", [_I, _I]),
    "w8p_matmul": ("stllm_w8p_matmul_occupancy", [_I, _I]),
    "w4_unpack_matmul": ("stllm_w4_unpack_matmul_occupancy", [_I, _I, _I]),
    "qmm_res_ln": ("stllm_qmm_res_ln_occupancy", [_I, _I, _I, _I]),
    "layer_norm_quant": ("stllm_layer_norm_quant_occupancy", [_I, _I, _I]),
    "gelu_quant": ("stllm_gelu_quant_occupancy", [_I, _I, _I]),
    "quant_matmul_blockwise": ("stllm_quant_matmul_occupancy", [_I, _I, _I, _I, _I, _I]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# the kernels with more than one form, the first the one an entry point
# without a form runs; FORM_LAUNCHES splits their LAUNCHES by form
# ("w4a16_matmul/decode")
FORMS = {"w4a16_matmul": ("stream", "wgmma", "decode"), "qmm_res_ln": ("rows", "cluster"),
         **{name: ("stream", "decode") for name in (
             "w4v3_matmul", "w8p_matmul", "w4_unpack_matmul")},
         "layer_norm_quant": ("registers", "any"), "gelu_quant": ("registers", "any"),
         **{name: ("tiles", "any") for name in (
             "packed_qkv_attention", "packed_qkv_attention_quant", "packed_qkv_attention_s8",
             "fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")}}
FORM_LAUNCHES: Dict[str, int] = {f"{n}/{f}": 0 for n, fs in FORMS.items() for f in fs}
BUILD_LOG: Dict[str, str] = {}   # nvcc output (ptxas register/spill report)
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}

_EXP2_CLAMP = 50.0
_LOG2E = 1.4426950408889634
# widest row the row-quant pass of #2 and #3 stages in a block's shared
# memory, and #9 and #10 hold in registers (csrc/rowwise_quant.cuh)
MAX_ROW = 12288
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _source_files(name: str) -> Tuple[Path, ...]:
    """The kernel's ``.cu`` file and every ``csrc`` header it includes,
    directly or through another header."""
    seen, todo = [], [CSRC / SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                    if (CSRC / inc).exists())
    return tuple(seen)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def nvcc_command(source: Path, out: Path, *flags: str) -> list:
    """The nvcc command that builds ``source`` into the shared library
    ``out`` for sm_90a (plain C interface, ptxas's register report on),
    with ``flags`` added (an include path)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", str(out),
            str(source)]


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_name(f"{out.name}.log"), "w+")
        cmd = nvcc_command(CSRC / SOURCES[name], tmp)
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


def _symbol(name: str, symbol: str, argtypes):
    """C function ``symbol`` of kernel ``name``'s library, building and
    loading the library first."""
    fn = _FNS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _launch(name: str, device: torch.device, *args, f32: bool = False,
            form: Optional[str] = None) -> None:
    """Launch kernel ``name`` (its fp32-io entry point with ``f32``, its
    second form's with ``form``) on ``device``'s current stream (appended as
    the last argument), raise on a refused launch, and count it."""
    symbol, argtypes = _FORM_ENTRY[name, form] if form else _ENTRY[name]
    fn = _symbol(name, _F32_SYMBOLS[name] if f32 else symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    if name in FORMS:
        FORM_LAUNCHES[f"{name}/{form or FORMS[name][0]}"] += 1


def occupancy(name: str, *shape: int) -> int:
    """Blocks of kernel ``name``'s bf16 instantiation one SM holds at once
    at ``shape`` (packed_qkv_attention, packed_qkv_attention_s8: S, D
    (the tile loop); flash_attention_fwd,
    flash_attention_bwd_dq, flash_attention_bwd_dkv: D;
    w4a16_matmul: the form (0 the tile loop, 1 wgmma, 2 decode, 3 the
    decode form's registers a thread), the tile loop's row tile (16 or 64)
    or the decode form's rows (up to 8 or 16); w4v3_matmul, w8p_matmul:
    the decode form's rows (up to 8 or 16), and 0 for its blocks an SM or 1
    for its registers a thread; w4_unpack_matmul: the variant's index in
    W4_UNPACK_VARIANTS, then as w4v3_matmul;
    qmm_res_ln: cluster form or not, blocks an SM (0)
    or clusters the card holds (1), M, N; layer_norm_quant, gelu_quant: K,
    fp32 rows or not, and 1 for the register form's registers a thread
    instead of its blocks an SM; quant_matmul_blockwise: M, K, N, bk, fp32
    x or not, and what: 0 the GEMM's blocks an SM, 1 its registers, 2 its
    tile width, 3 the quant pass's blocks an SM, 4 its registers), by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor (or MaxActiveClusters)
    on the current device."""
    fn = _symbol(name, *_OCCUPANCY[name])
    return int(fn(*shape))


def _check_cuda(name: str, t: torch.Tensor, *dtypes: torch.dtype) -> None:
    """The kernels take contiguous, 16-byte aligned CUDA tensors of one of
    ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} kernel takes {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte aligned tensor")


def rowwise_quant_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of fp32 rows (csrc/rowwise_quant.cuh):
    s = amax|y| / 127 (1 where amax == 0), q = round-half-even(y / s).
    Returns (int8 (..., K), fp32 (..., 1)). The divisor 127 is a tensor
    filled on y's device: torch divides a CUDA tensor by a Python number
    through its reciprocal, at times a scale one ulp from the IEEE quotient
    the kernels and the reference take (the fill replaces the ones the
    where took, so no launch is added)."""
    amax = y.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0.0, 1.0, amax / torch.full_like(amax, 127.0))
    return torch.round(y / s).to(torch.int8), s


# ---------------------------------------------------------------------------
# packed-qkv attention: bf16 (#1), with an int8 epilogue (#2), on static-int8
# qkv (#3)
# ---------------------------------------------------------------------------

PACKED_MAX_HEAD_DIM = 128   # widest head of the tile loops (csrc/packed_qkv_attention.cuh)
PACKED_ANY_ROWS = 8         # query rows of an "any" form block (csrc/packed_qkv_any.cuh)
PACKED_ANY_MAX_SEQ = 1023   # its scores of a row in shared memory: the reference's S < 1024
_GRID_MAX = 2 ** 31 - 1     # blocks of a one-dimensional grid
_GRID_YZ_MAX = 65535        # blocks along a grid's y or z


def packed_form(head_dim: int) -> str:
    """The form of #1, #2 and #3 that runs at ``head_dim``: "tiles" (the
    tensor-core tile loops, head_dim a multiple of 8 up to 128: every model
    of the repository) or "any" (a simple CUDA-core form for every other
    head_dim, csrc/packed_qkv_any.cuh)."""
    return "tiles" if head_dim % 8 == 0 and 0 < head_dim <= PACKED_MAX_HEAD_DIM else "any"


def packed_shape_ok(b: int, s: int, heads: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the packed kernels launch at (B, S, H, D) on a ``dtype`` qkv
    (#1 and #2: bf16 or fp32; #3: int8), in the form ``packed_form`` picks:
    B, S, H, D positive and grids that fit: B * S rows (the row-quant pass
    of #2 and #3); for the tile loops B * H * ceil(S / 16) blocks of a
    linear grid, and for their fp32 instantiation H and B along the grid's y
    and z; for the "any" form S <= 1023 and B * H * ceil(S / 8) blocks. Every
    H * D is taken: the row-quant pass reads a row too wide for a block's
    shared memory from device memory twice."""
    if min(b, s, heads, head_dim) <= 0 or b * s > _GRID_MAX:
        return False
    if packed_form(head_dim) == "any":
        return s <= PACKED_ANY_MAX_SEQ and b * heads * -(-s // PACKED_ANY_ROWS) <= _GRID_MAX
    if b * heads * -(-s // 16) > _GRID_MAX:
        return False
    return dtype != torch.float32 or max(b, heads) <= _GRID_YZ_MAX


def _check_packed(name: str, qkv: torch.Tensor, heads: int, head_dim: int,
                  *dtypes: torch.dtype) -> None:
    _check_cuda(name, qkv, *dtypes)
    if qkv.dim() != 3:
        raise ValueError(f"{name} kernel takes a (B, S, 3*H*D) tensor")
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv width {qkv.shape[-1]} != 3 * {heads} * {head_dim}")
    b, s, _ = qkv.shape
    if not packed_shape_ok(b, s, heads, head_dim, qkv.dtype):
        raise ValueError(f"{name} kernel ({packed_form(head_dim)} form): (B, S, H, D) = "
                         f"{(b, s, heads, head_dim)} must be positive and fit its grid")


def _packed_rows_plain(qkv: torch.Tensor, heads: int, head_dim: int,
                       scale: float) -> torch.Tensor:
    """The packed kernels' attention in fp32: s = q.k^T * scale * log2(e),
    p = exp2(min(s, 50) - 50) with no row max, P cast to the io dtype for
    P.V (fp32 accumulation), divided by sum(p) with a zero guard.
    Returns fp32 (B, S, H*D)."""
    b, s, _ = qkv.shape
    q, k, v = (t.reshape(b, s, heads, head_dim).transpose(1, 2).float()
               for t in qkv.chunk(3, dim=-1))
    sc = torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E)
    p = torch.exp2(torch.clamp(sc, max=_EXP2_CLAMP) - _EXP2_CLAMP)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.transpose(1, 2).reshape(b, s, heads * head_dim)


def packed_qkv_attention_plain(qkv: torch.Tensor, heads: int, head_dim: int,
                               scale: float) -> torch.Tensor:
    """Kernel #1's math in plain torch, out in the io dtype."""
    return _packed_rows_plain(qkv, heads, head_dim, scale).to(qkv.dtype)


def packed_qkv_attention(qkv: torch.Tensor, heads: int, head_dim: int,
                         scale: float) -> torch.Tensor:
    """Non-causal attention on packed (B, S, 3*H*D) qkv -> (B, S, H*D).
    CUDA: bf16 or fp32 (the fp32 instantiation), contiguous, in the form
    ``packed_form(head_dim)`` picks (``packed_shape_ok``)."""
    if qkv.device.type == "cpu":
        return packed_qkv_attention_plain(qkv, heads, head_dim, scale)
    _check_packed("packed_qkv_attention", qkv, heads, head_dim, torch.bfloat16, torch.float32)
    b, s, _ = qkv.shape
    f32 = qkv.dtype == torch.float32
    out = torch.empty((b, s, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    if not out.numel():
        return out
    args = (qkv.data_ptr(), out.data_ptr(), b, s, heads, head_dim, scale * _LOG2E)
    if packed_form(head_dim) == "any":
        _launch("packed_qkv_attention", qkv.device, *args, int(f32), form="any")
    else:
        _launch("packed_qkv_attention", qkv.device, *args, f32=f32)
    return out


def packed_qkv_attention_quant_plain(qkv: torch.Tensor, heads: int, head_dim: int,
                                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #2's math: the fp32 attention rows of #1, quantized per row
    over all H*D columns."""
    return rowwise_quant_plain(_packed_rows_plain(qkv, heads, head_dim, scale))


def packed_qkv_attention_quant(qkv: torch.Tensor, heads: int, head_dim: int,
                               scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-qkv attention with a per-row int8 epilogue: (B, S, 3*H*D) ->
    (int8 (B, S, H*D), fp32 (B, S, 1)). CUDA: as packed_qkv_attention; the
    kernel writes fp32 rows to a scratch buffer and a second launch
    quantizes them."""
    if qkv.device.type == "cpu":
        return packed_qkv_attention_quant_plain(qkv, heads, head_dim, scale)
    _check_packed("packed_qkv_attention_quant", qkv, heads, head_dim, torch.bfloat16,
                  torch.float32)
    b, s, _ = qkv.shape
    hd = heads * head_dim
    f32 = qkv.dtype == torch.float32
    out_q = torch.empty((b, s, hd), dtype=torch.int8, device=qkv.device)
    out_s = torch.empty((b, s, 1), dtype=torch.float32, device=qkv.device)
    if not out_q.numel():
        return out_q, out_s
    scratch = torch.empty((b, s, hd), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), scratch.data_ptr(), out_q.data_ptr(), out_s.data_ptr(), b, s,
            heads, head_dim, scale * _LOG2E)
    if packed_form(head_dim) == "any":
        _launch("packed_qkv_attention_quant", qkv.device, *args, int(f32), form="any")
    else:
        _launch("packed_qkv_attention_quant", qkv.device, *args, f32=f32)
    return out_q, out_s


def packed_qkv_attention_s8_plain(qkv_q: torch.Tensor, scales: torch.Tensor, heads: int,
                                  head_dim: int, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #3's math in plain torch: exact integer q.k^T times
    ((sq * sk * scale) * log2(e)) in fp32, the clamped exp2 softmax, bf16 P
    times the int8 V codes (fp32 accumulation), times sv / sum(p), then the
    per-row int8 epilogue. ``scales``: fp32 (3,) = (sq, sk, sv)."""
    b, s, _ = qkv_q.shape
    q, k, v = (t.reshape(b, s, heads, head_dim).transpose(1, 2).float()
               for t in qkv_q.chunk(3, dim=-1))
    sc = scales.float()
    qk = sc[0] * sc[1] * scale * _LOG2E
    logits = torch.matmul(q, k.transpose(-1, -2)) * qk
    p = torch.exp2(torch.clamp(logits, max=_EXP2_CLAMP) - _EXP2_CLAMP)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16).float(), v)
    o = o * (sc[2] / torch.where(l == 0.0, torch.ones_like(l), l))
    return rowwise_quant_plain(o.transpose(1, 2).reshape(b, s, heads * head_dim))


def packed_qkv_attention_s8(qkv_q: torch.Tensor, scales: torch.Tensor, heads: int,
                            head_dim: int, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-qkv attention on static-int8 (B, S, 3*H*D) qkv with per-third
    scales ``scales`` (fp32 (3,), on the tensor's device) -> (int8
    (B, S, H*D), fp32 (B, S, 1)). CUDA: int8, contiguous, in the form
    ``packed_form(head_dim)`` picks (``packed_shape_ok``); the scales stay
    on the device."""
    if qkv_q.device.type == "cpu":
        return packed_qkv_attention_s8_plain(qkv_q, scales, heads, head_dim, scale)
    _check_packed("packed_qkv_attention_s8", qkv_q, heads, head_dim, torch.int8)
    if (scales.device != qkv_q.device or scales.dtype != torch.float32
            or scales.numel() != 3 or not scales.is_contiguous()):
        raise ValueError("packed_qkv_attention_s8 kernel takes its 3 scales as a "
                         "contiguous fp32 tensor on the same device")
    b, s, _ = qkv_q.shape
    hd = heads * head_dim
    out_q = torch.empty((b, s, hd), dtype=torch.int8, device=qkv_q.device)
    out_s = torch.empty((b, s, 1), dtype=torch.float32, device=qkv_q.device)
    if out_q.numel():
        scratch = torch.empty((b, s, hd), dtype=torch.float32, device=qkv_q.device)
        form = packed_form(head_dim)
        _launch("packed_qkv_attention_s8", qkv_q.device, qkv_q.data_ptr(),
                scales.data_ptr(), scale, scratch.data_ptr(), out_q.data_ptr(),
                out_s.data_ptr(), b, s, heads, head_dim, form=None if form == "tiles" else form)
    return out_q, out_s


def _rowwise_quant_pass(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-quant pass of #2 and #3 (their second launch) alone, on
    contiguous fp32 CUDA rows (..., K), any K: (int8 (..., K), fp32 (..., 1)),
    the function of ``rowwise_quant_plain``. Not on any path and not counted:
    it lets a timing split #3 between its two launches."""
    _check_cuda("rowwise_quant", y, torch.float32)
    k = y.shape[-1]
    rows = y.numel() // max(k, 1)
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    s = torch.empty((*y.shape[:-1], 1), dtype=torch.float32, device=y.device)
    if rows:
        fn = _symbol("packed_qkv_attention_s8", "stllm_rowwise_quant", [_P, _P, _P, _LL, _I, _P])
        with torch.cuda.device(y.device):
            err = fn(y.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rowwise_quant kernel launch failed: CUDA error {err}")
    return q, s


# ---------------------------------------------------------------------------
# producer-fused row quantization: LayerNorm (#9) and GELU (#10)
# ---------------------------------------------------------------------------

def row_quant_form(k: int, dtype: torch.dtype) -> str:
    """The form of #9 and #10 that runs rows of width ``k`` and type
    ``dtype`` (bf16 or fp32): "registers" (csrc/rowwise_quant.cuh, the row
    held in registers by a group of threads) where the row is whole 16-byte
    chunks (k a multiple of 8 for bf16, of 4 for fp32) and at most 12288
    wide (every model: 1408 and 6144, or the widths of the tiny configs),
    else "any" (one block a row, read element by element; a row wider than
    12288 read from device memory once a pass)."""
    vec = 4 if dtype == torch.float32 else 8
    return "registers" if k % vec == 0 and 0 < k <= MAX_ROW else "any"


def _check_rows(name: str, x: torch.Tensor) -> int:
    _check_cuda(name, x, torch.bfloat16, torch.float32)
    k = x.shape[-1] if x.dim() else 0
    if k <= 0 or x.numel() // k > _GRID_MAX:
        raise ValueError(f"{name} kernel: row width {k} must be positive, the rows at most "
                         f"{_GRID_MAX}")
    return k


def _row_form(name: str, x: torch.Tensor, k: int, form: Optional[str]) -> Optional[str]:
    """The form a row-kernel call launches (``form``, else the rule's), as
    ``_launch`` takes it: None for the register form."""
    form = form or row_quant_form(k, x.dtype)
    if form not in FORMS[name]:
        raise ValueError(f"{name}: no form {form!r}")
    if form == "registers" and row_quant_form(k, x.dtype) != "registers":
        raise ValueError(f"{name}: the register form does not take rows of {k} {x.dtype}")
    return None if form == "registers" else form


def layer_norm_quant_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #9's math: fp32 LayerNorm statistics in the TPU kernel's
    order, then per-row int8 of the fp32 result."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return rowwise_quant_plain(y * gamma.float() + beta.float())


def layer_norm_quant(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm -> per-row int8: (..., K) -> (int8 (..., K), fp32 (..., 1)).
    CUDA: x bf16 or fp32, gamma and beta (K,) each bf16 or fp32, any K, in
    the form ``row_quant_form`` picks."""
    return _layer_norm_quant(x, gamma, beta, eps, None)


def _layer_norm_quant(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                      form: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """layer_norm_quant in ``form`` ("registers", or "any", which runs
    wherever the register form does; None: the rule's), as chip_smoke.py
    and the tests force one."""
    if x.device.type == "cpu":
        return layer_norm_quant_plain(x, gamma, beta, eps)
    k = _check_rows("layer_norm_quant", x)
    for p in (gamma, beta):
        _check_cuda("layer_norm_quant", p, torch.bfloat16, torch.float32)
        if tuple(p.shape) != (k,) or p.device != x.device:
            raise ValueError(f"layer_norm_quant: norm params {tuple(p.shape)} on {p.device} "
                             f"!= ({k},) on {x.device}")
    form = _row_form("layer_norm_quant", x, k, form)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q.numel():
        f32 = [int(t.dtype == torch.float32) for t in (x, gamma, beta)]
        _launch("layer_norm_quant", x.device, x.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // k, k, eps, *f32,
                form=form)
    return q, s


def gelu_quant_plain(x: torch.Tensor, approx: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #10's math: GELU in fp32 (erf, or tanh when ``approx``), then
    per-row int8."""
    return rowwise_quant_plain(F.gelu(x.float(), approximate="tanh" if approx else "none"))


def gelu_quant(x: torch.Tensor, approx: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """GELU -> per-row int8: (..., K) -> (int8 (..., K), fp32 (..., 1)).
    CUDA: bf16 or fp32, any K, in the form ``row_quant_form`` picks."""
    return _gelu_quant(x, approx, None)


def _gelu_quant(x: torch.Tensor, approx: bool, form: Optional[str]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gelu_quant in ``form`` (as _layer_norm_quant)."""
    if x.device.type == "cpu":
        return gelu_quant_plain(x, approx)
    k = _check_rows("gelu_quant", x)
    form = _row_form("gelu_quant", x, k, form)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q.numel():
        _launch("gelu_quant", x.device, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                x.numel() // k, k, int(approx), int(x.dtype == torch.float32), form=form)
    return q, s


# ---------------------------------------------------------------------------
# weight-streaming matmuls: W4A16 (#12) and the probes #13-#15
# ---------------------------------------------------------------------------

W4_UNPACK_VARIANTS = ("int32", "int16", "f32", "bf16", "and8")
BIASED_VARIANTS = ("f32", "bf16", "and8")   # on the p = 16 * b + (t + 8) layout
_WS_BN, _WS_BK = 128, 32            # the tile loop's output columns and weight rows per step
_WS_MIN_BLOCKS = 528                # four blocks on each of the H100's 132 SMs


def weight_stream_splits(m: int, n: int, kw: int) -> int:
    """Split-K factor of a weight-streaming launch: 1 when the (BM, 128)
    output tiles (BM 16 for m <= 16, else 64) give at least 528 blocks,
    else enough even shares of the ceil(kw / 32) weight-row steps to reach
    that many blocks, every share non-empty."""
    bm = 16 if m <= 16 else 64
    blocks = -(-m // bm) * -(-n // _WS_BN)
    steps = -(-kw // _WS_BK)
    splits = max(1, min(steps, _WS_MIN_BLOCKS // blocks))
    per = -(-steps // splits)
    return -(-steps // per)


W4_DECODE_ROWS = 16                 # the most rows the decode form takes


def w4a16_form(m: int) -> str:
    """Which form of #12 runs M rows: "decode" (csrc/w4a16_decode.cuh, one
    launch, the weight unpacked in registers, K split across a cluster) for
    M <= 16, else "wgmma", the Hopper mixed-input GEMM
    (csrc/w4a16_prefill.cuh). "stream", the weight-streaming tile loop both
    replaced, runs only where a caller asks for it."""
    return "decode" if m <= W4_DECODE_ROWS else "wgmma"


def probe_form(m: int) -> str:
    """Which form of the probes #13 and #14 runs M rows: "decode" (#12's
    decode form on their bytes) for M <= 16, else "stream", the tile loop."""
    return "decode" if m <= W4_DECODE_ROWS else "stream"


UNPACK_DECODE_ROWS = 8              # the most rows #15's route sends to the decode form


def unpack_form(m: int) -> str:
    """Which form of the probe #15 runs M rows: "decode" for M <= 8 (one n8
    tile of x rows), else "stream", the tile loop. On the H100 the decode
    form beats the tile loop at 4 and 8 rows and loses to it at the probe's
    16 (two n8 tiles; PERF.md, section 6), so only the rows where it wins take
    it; ``_w4_unpack_matmul(..., "decode")`` still runs it up to 16 rows."""
    return "decode" if m <= UNPACK_DECODE_ROWS else "stream"


def weight_stream_operands(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                           kw: int, halves: int):
    """The operands of a weight-streaming product at widths the kernels
    take (N and the weight rows in use multiples of 8): x (M, halves * kw),
    w (>= kw, N) int8, scale (N,) or None. N goes up to a multiple of 8 with
    zero weight columns and unit scales; kw goes up to one with zero x
    columns at the end of each half (``[x_top, 0, x_bot, 0]``, as
    ``stllm_tpu/ops/quant.py:w4_matmul_pallas`` pads its half-K) and weight
    rows: w's stored rows past kw where it has them (a zero x column makes
    every code's product 0), else zero rows of a padded copy. Returns (x,
    w, scale, kw), the tensors given where both widths are multiples of 8;
    the product's first N columns are the unpadded one's."""
    n = w.shape[1]
    kp, npad = -(-kw // 8) * 8, -(-n // 8) * 8
    if kp != kw:
        x = F.pad(x.reshape(x.shape[0], halves, kw), (0, kp - kw)).reshape(
            x.shape[0], halves * kp)
    if npad != n or w.shape[0] < kp:
        wp = w.new_zeros((kp, npad))
        wp[:kw, :n] = w[:kw]
        w = wp
    if scale is not None and npad != n:
        scale = torch.cat([scale, scale.new_ones(npad - n)])
    return x, w, scale, kp


def _weight_stream(name: str, x: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor], halves: int, flag: int,
                   out_dtype: torch.dtype, form: str = "stream") -> torch.Tensor:
    """Check and launch one weight-streaming kernel: x (..., K) cast to a
    contiguous bf16 (M, K), w (>= K / halves, N) int8, scale (N,) fp32 or
    None; the weight rows in use are K / halves. Pads the operands where N
    or K / halves is no multiple of 8 (``weight_stream_operands``),
    allocates the output (and, for the tile loop, the split-K scratch) and
    returns its first N columns. ``form`` "wgmma" or "decode" launches that
    form instead of the tile loop."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes a bf16 or fp32 x, got {x.dtype}")
    _check_cuda(name, w, torch.int8)
    if w.dim() != 2 or w.device != x.device:
        raise ValueError(f"{name} kernel takes a 2-D weight on the device of x")
    n = w.shape[1]
    if scale is not None:
        _check_cuda(name, scale, torch.float32)
        if tuple(scale.shape) != (n,) or scale.device != x.device:
            raise ValueError(f"{name}: scale {tuple(scale.shape)} != ({n},) on {x.device}")
    lead, k = x.shape[:-1], x.shape[-1]
    kw = k // halves
    if kw <= 0 or n <= 0:
        raise ValueError(f"{name} kernel: weight rows in use ({kw}) and N ({n}) must be positive")
    if w.shape[0] < kw:
        raise ValueError(f"{name}: the weight has {w.shape[0]} rows, x needs {kw}")
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    _check_cuda(name, x2, torch.bfloat16)
    m = x2.shape[0]
    if form == "decode" and m > W4_DECODE_ROWS:
        raise ValueError(f"{name}: the decode form takes at most {W4_DECODE_ROWS} rows, got {m}")
    x2, w, scale, kw = weight_stream_operands(x2, w, scale, kw, halves)
    npad = w.shape[1]
    out = torch.empty((m, npad), dtype=out_dtype, device=x.device)
    if m and form in ("wgmma", "decode"):
        _launch(name, x.device, x2.data_ptr(), w.data_ptr(), _ptr(scale), out.data_ptr(),
                m, npad, kw, flag, form=form)
    elif m:
        splits = weight_stream_splits(m, npad, kw)
        partial = (torch.empty((splits, m, npad), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        _launch(name, x.device, x2.data_ptr(), w.data_ptr(), _ptr(scale), out.data_ptr(),
                _ptr(partial), m, npad, kw, splits, flag)
    if npad != n:
        out = out[:, :n]
    return out.reshape(*lead, n)


def _halves_f32(x: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """bf16(x)[:, :k2] . top + bf16(x)[:, k2:] . bottom in fp32, k2 = K / 2;
    the bf16 products are exact in fp32."""
    xb = x.to(torch.bfloat16).float()
    k2 = x.shape[-1] // 2
    return xb[..., :k2] @ top.float() + xb[..., k2:] @ bottom.float()


def w4a16_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel #12's math: the first K/2 packed rows' two's-complement
    nibbles (low: x columns [0, K/2), high: [K/2, K)), fp32 accumulation of
    both halves, times the per-channel fp32 scale, out in x.dtype."""
    p = packed[: x.shape[-1] // 2].to(torch.int32)
    return (_halves_f32(x, (p << 28) >> 28, p >> 4) * scale.float()).to(x.dtype)


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W4A16: x (..., K) @ int4-packed (>= K/2, N) with per-channel scales
    -> (..., N) in x.dtype. CUDA: x bf16 or fp32 (multiplied as bf16), any
    even K and any N (``weight_stream_operands``); packed rows at K/2 and
    beyond are read only as padding against zero x columns. One form by M
    (``w4a16_form``): the decode form up to 16 rows, wgmma above."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, packed, scale)
    return _w4a16_matmul(x, packed, scale, w4a16_form(x.numel() // max(x.shape[-1], 1)))


def _w4a16_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  form: str) -> torch.Tensor:
    """#12 on the card in ``form`` ("stream", "wgmma" or, up to 16 rows,
    "decode"), whatever M is; chip_smoke.py times the tile loop (the design
    the other two forms replaced) through it."""
    if x.shape[-1] % 2:
        raise ValueError(f"w4a16_matmul: K ({x.shape[-1]}) must be even")
    if form not in FORMS["w4a16_matmul"]:
        raise ValueError(f"w4a16_matmul: form {form!r} not in {FORMS['w4a16_matmul']}")
    return _weight_stream("w4a16_matmul", x, packed, scale, 2, int(x.dtype == torch.float32),
                          x.dtype, form)


def pack_int4_arith(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Codes in [-7, 7] to the arithmetic layout of #13: 16 * bottom + top."""
    return (bottom.to(torch.int16) * 16 + top.to(torch.int16)).to(torch.int8)


def pack_int4_nibbles(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Codes in [-8, 7] to the nibble layout of #12 and #15's int32 and
    int16 variants: top in the low nibble, bottom in the high one."""
    return (top.to(torch.int8) & 0x0F) | (bottom.to(torch.int8) << 4)


def pack_int4_biased(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Codes in [-7, 7] to the biased layout of #15's f32, bf16 and and8
    variants: 16 * bottom + top + 8."""
    return (bottom.to(torch.int16) * 16 + top.to(torch.int16) + 8).to(torch.int8)


def pack_int4_variant(variant: str, top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Codes in [-7, 7] in the layout #15's ``variant`` reads: biased (f32,
    bf16, and8) or nibbles (int32, int16)."""
    biased = variant in BIASED_VARIANTS
    return (pack_int4_biased if biased else pack_int4_nibbles)(top, bottom)


def w4v3_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel #13's math: bottom = round(p / 16), top = p - 16 * bottom on
    the arithmetic layout, then as kernel #12."""
    p = packed[: x.shape[-1] // 2].float()
    bottom = torch.round(p * 0.0625)
    return (_halves_f32(x, p - 16.0 * bottom, bottom) * scale.float()).to(x.dtype)


def w4v3_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Probe #13: W4A16 on arithmetic-packed (>= K/2, N) bytes, per-channel
    scales -> (..., N) in x.dtype. CUDA: as w4a16_matmul, in the form
    ``probe_form`` picks by M (#12's decode form up to 16 rows, the tile
    loop above)."""
    if x.device.type == "cpu":
        return w4v3_matmul_plain(x, packed, scale)
    return _w4v3_matmul(x, packed, scale, probe_form(x.numel() // max(x.shape[-1], 1)))


def _w4v3_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 form: str) -> torch.Tensor:
    """#13 on the card in ``form`` ("stream" or, up to 16 rows, "decode"),
    whatever M is; chip_smoke.py times the tile loop through it."""
    if x.shape[-1] % 2:
        raise ValueError(f"w4v3_matmul: K ({x.shape[-1]}) must be even")
    if form not in FORMS["w4v3_matmul"]:
        raise ValueError(f"w4v3_matmul: form {form!r} not in {FORMS['w4v3_matmul']}")
    return _weight_stream("w4v3_matmul", x, packed, scale, 2, int(x.dtype == torch.float32),
                          x.dtype, form)


def w8p_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel #14's math: bf16 x times the int8 codes of the first K rows,
    fp32 accumulation, times the per-channel scale, out in x.dtype."""
    y = x.to(torch.bfloat16).float() @ w_q[: x.shape[-1]].float()
    return (y * scale.float()).to(x.dtype)


def w8p_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Probe #14: x (..., K) @ int8 (>= K, N) codes, convert only, times
    the per-channel scale -> (..., N) in x.dtype. CUDA: any K and N, in the
    form ``probe_form`` picks by M."""
    if x.device.type == "cpu":
        return w8p_matmul_plain(x, w_q, scale)
    return _w8p_matmul(x, w_q, scale, probe_form(x.numel() // max(x.shape[-1], 1)))


def _w8p_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                form: str) -> torch.Tensor:
    """#14 on the card in ``form`` ("stream" or, up to 16 rows, "decode"),
    whatever M is; chip_smoke.py times the tile loop through it."""
    if form not in FORMS["w8p_matmul"]:
        raise ValueError(f"w8p_matmul: form {form!r} not in {FORMS['w8p_matmul']}")
    return _weight_stream("w8p_matmul", x, w_q, scale, 1, int(x.dtype == torch.float32),
                          x.dtype, form)


def w4_unpack_matmul_plain(x: torch.Tensor, packed: torch.Tensor, variant: str) -> torch.Tensor:
    """Kernel #15's math for ``variant``, fp32 out, no scale: nibble layout
    (int32, int16), or biased layout (f32, bf16, and8) where the low code
    carries +8 and 8 * sum(bf16(x)[:, :K/2]) comes off every output."""
    if variant not in W4_UNPACK_VARIANTS:
        raise ValueError(f"unpack variant {variant!r} not in {W4_UNPACK_VARIANTS}")
    k2 = x.shape[-1] // 2
    p = packed[:k2].to(torch.int32)
    if variant not in BIASED_VARIANTS:
        return _halves_f32(x, (p << 28) >> 28, p >> 4)
    v = p.float()
    bottom = torch.floor(v * 0.0625)
    xt = x[..., :k2].to(torch.bfloat16).float()
    return _halves_f32(x, v - 16.0 * bottom, bottom) - 8.0 * xt.sum(dim=-1, keepdim=True)


def w4_unpack_matmul(x: torch.Tensor, packed: torch.Tensor, variant: str) -> torch.Tensor:
    """Probe #15: x (..., K) @ unpack(packed (>= K/2, N)) by ``variant``
    (one of W4_UNPACK_VARIANTS) -> fp32 (..., N), no scale. CUDA: any even
    K and any N, in the form ``unpack_form`` picks by M."""
    if x.device.type == "cpu":
        return w4_unpack_matmul_plain(x, packed, variant)
    return _w4_unpack_matmul(x, packed, variant,
                             unpack_form(x.numel() // max(x.shape[-1], 1)))


def _w4_unpack_matmul(x: torch.Tensor, packed: torch.Tensor, variant: str,
                      form: str) -> torch.Tensor:
    """#15 on the card in ``form`` ("stream" or, up to 16 rows, "decode"),
    whatever M is; chip_smoke.py times the tile loop through it."""
    if variant not in W4_UNPACK_VARIANTS:
        raise ValueError(f"unpack variant {variant!r} not in {W4_UNPACK_VARIANTS}")
    if x.shape[-1] % 2:
        raise ValueError(f"w4_unpack_matmul: K ({x.shape[-1]}) must be even")
    if form not in FORMS["w4_unpack_matmul"]:
        raise ValueError(f"w4_unpack_matmul: form {form!r} not in {FORMS['w4_unpack_matmul']}")
    return _weight_stream("w4_unpack_matmul", x, packed, None, 2,
                          W4_UNPACK_VARIANTS.index(variant), torch.float32, form)


# ---------------------------------------------------------------------------
# the training path's attention: fused short (#7), flash forward (#4) and
# backward (#5 dQ, #6 dK and dV). q, k, v: (B, S, H, D); kv_mask: (B, Sk),
# nonzero = a real token, or None.
# ---------------------------------------------------------------------------

NEG_INF = -1e30
LSE_MASKED = 1e30        # logsumexp of a row with no visible key: exp(s - lse) == 0
ATTN_MAX_HEAD_DIM = 128  # widest head of the tile loops (csrc/flash_attention.cuh)


def attn_form(head_dim: int) -> str:
    """The form of #4-#7 that runs at ``head_dim``: "tiles" (the tile loops
    of csrc/flash_attention.cuh, and their fp32 instantiations) up to 128,
    a head_dim that is no multiple of 8 zero-padded to one
    (``attn_padded_width``); "any" (csrc/flash_attention_any.cuh, simple
    CUDA-core loops) above 128, as the reference pads any head_dim to its
    lane width."""
    return "tiles" if head_dim <= ATTN_MAX_HEAD_DIM else "any"


def attn_padded_width(head_dim: int) -> int:
    """The head width a #4-#7 launch runs at: the tile loops take multiples
    of 8, so a narrower head goes up to the next one (zero columns: they add
    nothing to q.k^T, and give output, dq, dk and dv columns that are
    sliced off; the scale comes from the true head_dim); the "any" form
    takes every width as it is."""
    return -(-head_dim // 8) * 8 if attn_form(head_dim) == "tiles" else head_dim


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """(..., D) with zero columns up to ``width`` (t itself at D = width)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _visible(q: torch.Tensor, k: torch.Tensor, kv_mask: Optional[torch.Tensor],
             causal: bool, offset: int) -> Optional[torch.Tensor]:
    """(B or 1, 1, Sq, Sk) bool, True where query row i sees the key
    (unmasked and, if causal, key <= i + offset); None when every key is
    visible."""
    sq, sk = q.shape[1], k.shape[1]
    vis = None
    if kv_mask is not None:
        vis = (kv_mask > 0)[:, None, None, :].expand(-1, 1, sq, sk)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + offset
        tri = (torch.arange(sk, device=q.device)[None, :] <= qi)[None, None]
        vis = tri if vis is None else vis & tri
    return vis


def _heads_first(*ts: torch.Tensor):
    return tuple(t.transpose(1, 2).float() for t in ts)


def fused_short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                kv_mask: Optional[torch.Tensor], causal: bool,
                                scale: float) -> torch.Tensor:
    """Kernel #7's math: s = (q . k^T) * scale in fp32, hidden scores at
    -1e30 (causal with offset Sk - Sq), the max-subtracted softmax over the
    full row with the zero-sum guard, P cast to v's dtype, P . V with fp32
    accumulation, out in q's dtype."""
    qt, kt, vt = _heads_first(q, k, v)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    vis = _visible(q, k, kv_mask, causal, k.shape[1] - q.shape[1])
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    return torch.matmul(p.to(v.dtype).float(), vt).transpose(1, 2).to(q.dtype)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor], causal: bool,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4's math: s = (q * scale) . k^T in fp32 over the visible keys
    (causal is key <= query, no offset), P in fp32 for P . V. Returns (out in
    q's dtype, lse fp32 (B, H, Sq)); a row with no visible key gives 0 and
    LSE_MASKED."""
    qt, kt, vt = _heads_first(q, k, v)
    s = torch.matmul(qt * scale, kt.transpose(-1, -2))
    vis = _visible(q, k, kv_mask, causal, 0)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.matmul(p, vt) / safe
    lse = torch.where(empty, LSE_MASKED, m + torch.log(safe))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor], d_out: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                              scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernels #5 and #6's math from the forward's saved values: p = exp(s -
    lse) on the visible keys, dv = p^T . dO, ds = p * (dO . v^T - delta) *
    scale, dq = ds . k, dk = ds^T . q, all in fp32, each cast to its input's
    dtype. lse and delta: fp32 (B, H, Sq)."""
    qt, kt, vt, gt = _heads_first(q, k, v, d_out)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    vis = _visible(q, k, kv_mask, causal, 0)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dv = torch.matmul(p.transpose(-1, -2), gt)
    ds = p * (torch.matmul(gt, vt.transpose(-1, -2)) - delta[..., None]) * scale
    dq = torch.matmul(ds, kt)
    dk = torch.matmul(ds.transpose(-1, -2), qt)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _attn_args(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_mask: Optional[torch.Tensor], d_out: Optional[torch.Tensor] = None):
    """Check the tensors of one training-attention launch and return
    (tensors the kernel can read in place, strides array, int32 mask or
    None, (B, Sq, Sk, H, width), form): bf16 (the tensor-core kernels) or
    fp32 (their fp32 instantiations), one dtype for all, at any head_dim;
    ``width`` is ``attn_padded_width(head_dim)``, the tensors zero-padded to
    it. A tensor whose head dimension is not contiguous, or whose strides or
    address break the 16-byte loads, is copied to a contiguous one first."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d_out is not None and d_out.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(d_out.shape)} != q {tuple(q.shape)}")
    if 0 in (b, sq, sk, h, d):
        raise ValueError(f"{name} kernel takes no empty tensor: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    width = attn_padded_width(d)
    ts = []
    for t in (q, k, v) + (() if d_out is None else (d_out,)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for {t.device}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"{name} kernel takes torch.bfloat16 or torch.float32, one "
                            f"dtype for q, k, v and dO; got {t.dtype} beside q's {q.dtype}")
        t = pad_head_dim(t, width)
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            t = t.contiguous()
        ts.append(t)
    strides = [st for t in ts for st in (t.stride(0), t.stride(1), t.stride(2))]
    strides += [0] * (12 - len(strides))
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk) or kv_mask.device != q.device:
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} on {kv_mask.device}, "
                             f"want ({b}, {sk}) on {q.device}")
        mask = (kv_mask > 0).to(torch.int32).contiguous()
    return (ts, (ctypes.c_longlong * 12)(*strides), mask, (b, sq, sk, h, width),
            attn_form(d))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _attn_launch(name: str, q: torch.Tensor, form: str, *args) -> None:
    """Launch one of #4-#7 in ``form`` with its arguments (without the
    stream): the "any" form's entry point takes the io dtype as well."""
    f32 = q.dtype == torch.float32
    if form == "any":
        _launch(name, q.device, *args, int(f32), form="any")
    else:
        _launch(name, q.device, *args, f32=f32)


def _head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel's (..., width) output at the caller's head_dim ``d``."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def fused_short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor], causal: bool,
                          scale: float) -> torch.Tensor:
    """Single-pass attention for short sequences (#7): (B, Sq, H, D) out.
    CUDA: bf16 or fp32, any head_dim, in the form ``attn_form`` picks; q, k,
    v read in place through their strides where no padding is needed."""
    if q.device.type == "cpu":
        return fused_short_attention_plain(q, k, v, kv_mask, causal, scale)
    name = "fused_short_attention"
    d = q.shape[-1]
    (q, k, v), strides, mask, (b, sq, sk, h, w), form = _attn_args(name, q, k, v, kv_mask)
    out = torch.empty((b, sq, h, w), dtype=q.dtype, device=q.device)
    _attn_launch(name, q, form, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, _ptr(mask),
                 out.data_ptr(), b, sq, sk, h, w, int(causal), scale)
    return _head_dim(out, d)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (#4): (out (B, Sq, H, D), lse fp32 (B, H, Sq)).
    CUDA: as fused_short_attention."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    name = "flash_attention_fwd"
    d = q.shape[-1]
    (q, k, v), strides, mask, (b, sq, sk, h, w), form = _attn_args(name, q, k, v, kv_mask)
    out = torch.empty((b, sq, h, w), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _attn_launch(name, q, form, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, _ptr(mask),
                 out.data_ptr(), lse.data_ptr(), b, sq, sk, h, w, int(causal), scale)
    return _head_dim(out, d), lse


def _check_rows_f32(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: lse and delta are fp32 {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor], d_out: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                           scale: float) -> torch.Tensor:
    """Flash attention backward, dQ (#5), in q's dtype. lse, delta: fp32
    (B, H, Sq). CUDA: as fused_short_attention."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, d_out, lse, delta, causal, scale)[0]
    name = "flash_attention_bwd_dq"
    d = q.shape[-1]
    (q, k, v, d_out), strides, mask, (b, sq, sk, h, w), form = _attn_args(
        name, q, k, v, kv_mask, d_out)
    lse = _check_rows_f32(name, lse, (b, h, sq), q.device)
    delta = _check_rows_f32(name, delta, (b, h, sq), q.device)
    dq = torch.empty((b, sq, h, w), dtype=q.dtype, device=q.device)
    _attn_launch(name, q, form, q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
                 strides, _ptr(mask), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 b, sq, sk, h, w, int(causal), scale)
    return _head_dim(dq, d)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_mask: Optional[torch.Tensor], d_out: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention backward, dK and dV (#6), in k's and v's dtype.
    CUDA: as fused_short_attention."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, d_out, lse, delta, causal, scale)[1:]
    name = "flash_attention_bwd_dkv"
    d = q.shape[-1]
    (q, k, v, d_out), strides, mask, (b, sq, sk, h, w), form = _attn_args(
        name, q, k, v, kv_mask, d_out)
    lse = _check_rows_f32(name, lse, (b, h, sq), q.device)
    delta = _check_rows_f32(name, delta, (b, h, sq), q.device)
    dk = torch.empty((b, sk, h, w), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, w), dtype=v.dtype, device=q.device)
    _attn_launch(name, q, form, q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
                 strides, _ptr(mask), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, sq, sk, h, w, int(causal), scale)
    return _head_dim(dk, d), _head_dim(dv, d)


# ---------------------------------------------------------------------------
# int8 GEMMs: the s8 matmul with the epilogue-carried LayerNorm (#11) and the
# blockwise dynamic-quant matmul (#8). Both kernels read the (K, N) weight
# column-major, the layout quantize_weights and load_jax_params store; a
# row-major weight is copied to that layout per call, as _int8_dot does.
# ---------------------------------------------------------------------------

QMM_MAX_N = 1536         # widest output row #11 takes in one pass; wider rows are staged
QMM_CLUSTER = 8          # CTAs of a cluster of #11's cluster form, each a 1/8 slice of N
QMM_CLUSTER_SLICES = (128, 176, 256)   # the slice widths it is built for (csrc/qmm_res_ln.cu)


def qmm_res_ln_form(m: int, n: int, dtype: torch.dtype) -> str:
    """Which form of #11 runs M rows of width N with x_prev in ``dtype``:
    "cluster" (clusters of 8 CTAs, each a slice of N / 8 columns, wgmma s8)
    where N / 8 is one of QMM_CLUSTER_SLICES (N = 1024, 1408, 2048: the
    ViT-g sites are 1408) and x_prev is bf16 or fp32, at any M >= 1; else
    "rows", the 16-row kernels (one pass up to QMM_MAX_N columns, chunked
    above)."""
    if m >= 1 and n % QMM_CLUSTER == 0 and n // QMM_CLUSTER in QMM_CLUSTER_SLICES \
            and dtype in (torch.bfloat16, torch.float32):
        return "cluster"
    return "rows"


def _column_major(name: str, w_q: torch.Tensor, k: int, device) -> torch.Tensor:
    """The (K, N) int8 weight as the kernels read it: its transpose, (N, K)
    contiguous."""
    if w_q.dim() != 2 or w_q.shape[0] != k or w_q.device != device:
        raise ValueError(f"{name}: weight {tuple(w_q.shape)} on {w_q.device}, want ({k}, N) "
                         f"on {device}")
    wt = w_q.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    _check_cuda(name, wt, torch.int8)
    return wt


def _f32_vector(name: str, t: torch.Tensor, n: int, device) -> torch.Tensor:
    t = t.to(torch.float32).contiguous()
    if t.numel() != n or t.device != device:
        raise ValueError(f"{name}: a vector of {tuple(t.shape)} on {t.device}, want {n} on {device}")
    return t


def qmm_res_ln_plain(hq: torch.Tensor, hs: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, bias: Optional[torch.Tensor], x_prev: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor, out_scale: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #11's math in its order: y = (acc * hs) * w_scale + bias on the
    exact int32 product, xn = x_prev + y in fp32, x_new = xn in x_prev's
    dtype, LayerNorm of xn (two-pass variance, rsqrt, affine), then
    clip(round(z * (1 / out_scale)), -127, 127). (The exact int8 product is
    ops/quant.py's, imported here: that module imports this one.)"""
    from stllm_tpu_torch.ops.quant import _int8_dot

    y = _int8_dot(hq, w_q) * hs.float() * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    xn = x_prev.float() + y
    mean = xn.mean(dim=-1, keepdim=True)
    var = (xn - mean).square().mean(dim=-1, keepdim=True)
    z = (xn - mean) * torch.rsqrt(var + eps)
    z = z * gamma.float() + beta.float()
    inv_os = 1.0 / out_scale.float()
    return xn.to(x_prev.dtype), torch.clamp(torch.round(z * inv_os), -127, 127).to(torch.int8)


def qmm_res_ln(hq: torch.Tensor, hs: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor], x_prev: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, out_scale: torch.Tensor, eps: float = 1e-6
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s8 matmul, bias, residual add, LayerNorm and static int8 in one
    kernel: hq int8 (..., K), hs fp32 per row (..., 1) or one scalar, w_q
    int8 (K, N), w_scale and bias (N,), x_prev (..., N), gamma and beta (N,),
    out_scale one fp32 -> (x_new (..., N) in x_prev's dtype, yq int8
    (..., N)). CUDA: N a multiple of 128, x_prev bf16 or fp32; the scales
    stay on the device. One launch: a row up to QMM_MAX_N columns wide in one
    pass, a wider one in chunks through an fp32 (M, N) scratch row this
    allocates. A K that is not a multiple of 16 is padded with zero codes
    (hq and the weight copied), which leaves the exact products alone. The
    form follows ``qmm_res_ln_form``."""
    if hq.device.type == "cpu":
        return qmm_res_ln_plain(hq, hs, w_q, w_scale, bias, x_prev, gamma, beta, out_scale, eps)
    m = hq.numel() // max(hq.shape[-1], 1)
    return _qmm_res_ln(hq, hs, w_q, w_scale, bias, x_prev, gamma, beta, out_scale, eps,
                       qmm_res_ln_form(m, w_q.shape[-1], x_prev.dtype))


def _qmm_res_ln(hq: torch.Tensor, hs: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], x_prev: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, out_scale: torch.Tensor, eps: float, form: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """#11 on the card in ``form`` ("cluster" or "rows"); chip_smoke.py
    times the 16-row kernel at the ViT-g sites (the design the cluster form
    replaced) through it."""
    name = "qmm_res_ln"
    dev = hq.device
    _check_cuda(name, hq, torch.int8)
    k, n = hq.shape[-1], w_q.shape[-1]
    if k <= 0 or n <= 0 or n % 128:
        raise ValueError(f"{name} kernel: K ({k}) must be positive and N ({n}) a positive "
                         "multiple of 128")
    if tuple(x_prev.shape) != tuple(hq.shape[:-1]) + (n,):
        raise ValueError(f"{name}: x_prev {tuple(x_prev.shape)} for hq {tuple(hq.shape)}, N {n}")
    if x_prev.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes a bf16 or fp32 x_prev, got {x_prev.dtype}")
    _check_cuda(name, x_prev, x_prev.dtype)
    wt = _column_major(name, w_q, k, dev)
    m = hq.numel() // k
    hq = hq.reshape(m, k)
    if k % 16:
        kp = -(-k // 16) * 16
        hq = F.pad(hq, (0, kp - k))
        wt = F.pad(wt, (0, kp - k))
    hs32 = hs.to(torch.float32).contiguous()
    if hs32.device != dev or hs32.numel() not in (1, m):
        raise ValueError(f"{name}: hs has {hs32.numel()} values on {hs32.device} for {m} "
                         f"rows on {dev}")
    os32 = _f32_vector(name, out_scale, 1, dev)
    ws, g, b = (_f32_vector(name, t, n, dev) for t in (w_scale, gamma, beta))
    bias = None if bias is None else _f32_vector(name, bias, n, dev)
    x_new = torch.empty_like(x_prev)
    yq = torch.empty(x_prev.shape, dtype=torch.int8, device=dev)
    if m and form == "cluster":
        if qmm_res_ln_form(m, n, x_prev.dtype) != "cluster":
            raise ValueError(f"{name}: no cluster form for N {n}")
        _launch(name, dev, hq.data_ptr(), hs32.data_ptr(), int(hs32.numel() > 1),
                wt.data_ptr(), ws.data_ptr(), _ptr(bias), x_prev.data_ptr(), g.data_ptr(),
                b.data_ptr(), os32.data_ptr(), x_new.data_ptr(), yq.data_ptr(),
                m, hq.shape[-1], n, eps, int(x_prev.dtype == torch.float32), form=form)
    elif m:
        staged = (torch.empty((m, n), dtype=torch.float32, device=dev) if n > QMM_MAX_N
                  else None)
        _launch(name, dev, hq.data_ptr(), hs32.data_ptr(), int(hs32.numel() > 1),
                wt.data_ptr(), ws.data_ptr(), _ptr(bias), x_prev.data_ptr(), g.data_ptr(),
                b.data_ptr(), os32.data_ptr(), x_new.data_ptr(), yq.data_ptr(), _ptr(staged),
                m, hq.shape[-1], n, eps, int(x_prev.dtype == torch.float32))
    return x_new, yq


def quant_matmul_blockwise_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                                 bk: int) -> torch.Tensor:
    """Kernel #8's math: each k-block of bk columns quantized per row
    (rowwise_quant_plain), its exact int32 product cast to fp32 and times
    that block's row scales, added into the fp32 accumulator block by block;
    then times w_scale, out in x's dtype."""
    from stllm_tpu_torch.ops.quant import _int8_dot

    xf = x.float()
    acc = None
    for k0 in range(0, x.shape[-1], bk):
        q, s = rowwise_quant_plain(xf[..., k0:k0 + bk])
        part = _int8_dot(q, w_q[k0:k0 + bk]) * s
        acc = part if acc is None else acc + part
    return (acc * w_scale.float()).to(x.dtype)


QMM_BLOCK_STEP = 128   # #8's K bytes a stage: a k-block below K is whole stages


def _blockwise_args(name: str, x: torch.Tensor, bk: int) -> Tuple[int, int, int]:
    """#8's checks on the card: x bf16 or fp32, bk dividing K and, below K,
    a multiple of QMM_BLOCK_STEP (the reference picks K or a multiple of
    128). Returns (M, K, Kp), Kp = K rounded up to 16."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes a bf16 or fp32 x, got {x.dtype}")
    _check_cuda(name, x, x.dtype)
    k = x.shape[-1] if x.dim() else 0
    if k <= 0 or bk <= 0 or k % bk or (bk != k and bk % QMM_BLOCK_STEP):
        raise ValueError(f"{name} kernel: the k-block ({bk}) must divide K ({k}) and, below K, "
                         f"be a multiple of {QMM_BLOCK_STEP}")
    return x.numel() // k, k, -(-k // 16) * 16


def quant_matmul_blockwise(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                           bk: int) -> torch.Tensor:
    """Dynamic W8A8 with the activations quantized per (row, k-block of bk):
    x (..., K) @ w_q (K, N) int8 with w_scale (N,) -> (..., N) in x's dtype.
    CUDA: x bf16 or fp32, any K and N; bk divides K and, below K, is a
    multiple of 128. Two launches: the quant pass writes the codes into an
    (M, Kp) scratch this allocates (Kp = K rounded up to 16), then the GEMM.
    A K that is no multiple of 16 takes a copy of the weight padded with
    zero codes."""
    if x.device.type == "cpu":
        return quant_matmul_blockwise_plain(x, w_q, w_scale, bk)
    name = "quant_matmul_blockwise"
    m, k, kp = _blockwise_args(name, x, bk)
    n = w_q.shape[-1]
    wt = _column_major(name, w_q, k, x.device)
    if kp != k:
        wt = F.pad(wt, (0, kp - k))
    ws = _f32_vector(name, w_scale, n, x.device)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    if m and n:
        codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)
        scales = torch.empty((m, k // bk), dtype=torch.float32, device=x.device)
        _launch(name, x.device, x.data_ptr(), int(x.dtype == torch.float32), wt.data_ptr(),
                ws.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n, bk)
    return out


def _blockwise_quant_pass(x: torch.Tensor, bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """#8's first launch alone (uncounted: for its checks and its share of
    the time): x (..., K) on the card -> codes int8 (M, Kp) with a zero
    tail past K, scales fp32 (M, K / bk)."""
    name = "quant_matmul_blockwise"
    m, k, kp = _blockwise_args(name, x, bk)
    codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, k // bk), dtype=torch.float32, device=x.device)
    if m:
        fn = _symbol(name, "stllm_blockwise_quant", [_P, _I, _P, _P, _I, _I, _I, _P])
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
                     scales.data_ptr(), m, k, bk, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} quant pass launch failed: CUDA error {err}")
    return codes, scales
