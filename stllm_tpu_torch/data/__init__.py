"""Data layer: processors, frame samplers, video readers, packing.

Importing this package registers the processors in the Registry, as the
JAX package's does."""

from stllm_tpu_torch.data import processors as _processors  # noqa: F401  (registry side effect)
