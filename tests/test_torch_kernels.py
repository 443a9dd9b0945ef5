"""PyTorch port, CUDA kernels on the card (marker ``cuda``): each kernel
against its plain PyTorch version at the shapes the video-QA path gives it.
Skipped without a CUDA card; on the card run

    python -m pytest -m cuda tests/test_torch_kernels.py

Tolerance: the bf16 attention tolerance of tests/test_ops.py (atol = rtol =
3e-2); the kernel and its plain version differ only in summation order."""

import pytest
import torch

from stllm_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(16, 257, 16, 88), (256, 16, 16, 88), (3, 37, 4, 88),
                                   (2, 37, 4, 24), (1, 19, 2, 88), (2, 130, 3, 64)])
def test_packed_qkv_kernel_matches_plain(card, shape):
    b, s, h, d = shape
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(b, s, h * d, generator=gen, device=card)
    w = torch.randn(h * d, 3 * h * d, generator=gen, device=card) * 0.02
    qkv = (x @ w).to(torch.bfloat16)
    before = kernels.LAUNCHES["packed_qkv_attention"]
    got = kernels.packed_qkv_attention(qkv, h, d, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["packed_qkv_attention"] == before + 1
    want = kernels.packed_qkv_attention_plain(qkv, h, d, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_packed_qkv_kernel_refuses_what_it_cannot_take(card):
    qkv = torch.zeros((1, 4, 3 * 2 * 88), device=card)
    with pytest.raises(TypeError):
        kernels.packed_qkv_attention(qkv, 2, 88, 0.1)          # fp32
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(qkv.bfloat16()[:, ::2], 2, 88, 0.1)  # strided
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(torch.zeros((1, 4, 3 * 2 * 20), device=card,
                                                 dtype=torch.bfloat16), 2, 20, 0.1)
