"""stllm_tpu_torch: the PyTorch and CUDA port of stllm_tpu for NVIDIA Hopper.

The JAX package ``stllm_tpu`` is the reference; this package mirrors its
module layout and parameter trees and imports none of it.

Matmul precision is pinned here, once for the package: float32 products run
in full float32 (no TF32 in cuBLAS or cuDNN), and bf16 products accumulate
in float32 without cuBLAS's reduced-precision split-K reductions. That is the
reference's policy (bf16 operands, fp32 accumulation, fp32 islands exact).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

import os as _os

from stllm_tpu_torch.common.registry import registry

_root = _os.path.dirname(_os.path.abspath(__file__))
registry.register_path("library_root", _root)
registry.register_path("repo_root", _os.path.dirname(_root))
registry.register_path("cache_root", _os.environ.get("STLLM_CACHE",
                                                     _os.path.join(_os.path.dirname(_root), ".cache")))
registry.register("MAX_INT", 2**31 - 1)
registry.register("SPLIT_NAMES", ["train", "val", "test"])
