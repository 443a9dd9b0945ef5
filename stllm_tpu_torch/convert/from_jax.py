"""JAX parameter pytree -> the port's tensors under the same key paths.

The port keeps the reference's tree layout (linear ``w`` is (in, out), the
same dict and list nesting), so conversion is a copy by key path.
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
    None. bf16 leaves copy bit-exactly. Default device: the CUDA card."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _to_tensor(x, dev)

    return conv(tree)
