"""JAX parameter pytree -> the port's tensors under the same key paths.

The port keeps the reference's tree layout (linear ``w`` is (in, out), the
same dict and list nesting), so conversion is a copy by key path. One
layout differs: a 2-D int8 ``w_q`` leaf (the (K, N) codes of an int8
linear) is stored column-major, as the port's own ``quantize_weights``
stores it, with the same values, shape and dtype: the int8 products on the
card (``torch._int_mm``, kernels #8 and #11) read it in that layout without
a copy per call. The same
rule carries a gradient tree or a ``TrainState``'s two partitions across:
the reference marks a leaf that lives in the other partition with a sentinel
object, which converts to None here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from stllm_tpu_torch.common.device import resolve_device


def _to_tensor(leaf, device: torch.device) -> torch.Tensor:
    a = np.array(leaf)   # a private copy: torch must not alias a read-only buffer
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch.from_numpy route: move the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def load_jax_params(tree: Any, device=None) -> Any:
    """``tree``: the JAX parameter pytree as nested dicts, lists and numpy
    arrays (pulled off the device with ``np.asarray``); ``None`` leaves stay
    None, and so does any leaf that is not an array (the partition
    sentinel of a gradient or trainable tree). bf16 leaves copy bit-exactly.
    Default device: the CUDA card."""
    dev = resolve_device(device)

    def conv(x, key=None):
        if x is None or not (isinstance(x, (dict, list, tuple)) or hasattr(x, "shape")):
            return None   # None, or the reference's "absent from this partition" sentinel
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        t = _to_tensor(x, dev)
        if key == "w_q" and t.dim() == 2 and t.dtype == torch.int8:
            t = t.t().contiguous().t()   # column-major (K, N): stride(0) == 1
        return t

    return conv(tree)


def load_jax_partition(trainable: Any, frozen: Any, device=None) -> Any:
    """The whole parameter tree from a reference ``TrainState``'s two
    partitions (``state.params`` and ``state.frozen``): each leaf comes from
    the tree that holds it."""
    def merge(a, b):
        if isinstance(a, dict):
            return {k: merge(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(merge(x, y) for x, y in zip(a, b))
        return b if a is None else a

    return merge(load_jax_params(trainable, device), load_jax_params(frozen, device))
