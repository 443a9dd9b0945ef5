"""PyTorch port, CUDA kernels on the card (marker ``cuda``): each kernel
against its plain PyTorch version at the shapes the video-QA paths give it.
Skipped without a CUDA card; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: bf16 attention outputs within the bf16 attention tolerance of
tests/test_ops.py (atol = rtol = 3e-2); the kernel and its plain version
differ only in summation order. The int8 kernels: codes at most one step
apart (an fp32 value at a rounding boundary may round either way), and the
dequantized outputs within the same atol = rtol = 3e-2."""

import pytest
import torch

from stllm_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

INT8_ATOL = INT8_RTOL = 3e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _qkv(card, b, s, h, d):
    """LN-scale activations times 0.02-std weights, as the qkv projection
    makes them."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(b, s, h * d, generator=gen, device=card)
    w = torch.randn(h * d, 3 * h * d, generator=gen, device=card) * 0.02
    return (x @ w).to(torch.bfloat16)


def _assert_int8_close(got, want):
    (gq, gs), (wq, ws) = got, want
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert gq.shape == wq.shape and gs.shape == ws.shape
    assert int((gq.int() - wq.int()).abs().max()) <= 1
    torch.testing.assert_close(gq.float() * gs, wq.float() * ws,
                               atol=INT8_ATOL, rtol=INT8_RTOL)


def _counted(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


PACKED_SHAPES = [(16, 257, 16, 88), (256, 16, 16, 88), (3, 37, 4, 88),
                 (2, 37, 4, 24), (1, 19, 2, 88), (2, 130, 3, 64)]


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_qkv_kernel_matches_plain(card, shape):
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d)
    got = _counted("packed_qkv_attention",
                   lambda: kernels.packed_qkv_attention(qkv, h, d, d ** -0.5))
    want = kernels.packed_qkv_attention_plain(qkv, h, d, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_qkv_quant_kernel_matches_plain(card, shape):
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d)
    got = _counted("packed_qkv_attention_quant",
                   lambda: kernels.packed_qkv_attention_quant(qkv, h, d, d ** -0.5))
    _assert_int8_close(got, kernels.packed_qkv_attention_quant_plain(qkv, h, d, d ** -0.5))


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_qkv_s8_kernel_matches_plain(card, shape):
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d).float()
    amax = qkv.abs().reshape(b, s, 3, h * d).amax(dim=(0, 1, 3))
    scales = (amax / 127.0).contiguous()
    qkv_q = torch.clamp(torch.round(qkv.reshape(b, s, 3, h * d) / scales[:, None]),
                        -127, 127).to(torch.int8).reshape(b, s, 3 * h * d)
    got = _counted("packed_qkv_attention_s8",
                   lambda: kernels.packed_qkv_attention_s8(qkv_q, scales, h, d, d ** -0.5))
    _assert_int8_close(got, kernels.packed_qkv_attention_s8_plain(qkv_q, scales, h, d,
                                                                  d ** -0.5))


@pytest.mark.parametrize("shape", [(16, 257, 1408), (3, 37, 1408), (2, 5, 64)])
def test_layer_norm_quant_kernel_matches_plain(card, shape):
    gen = torch.Generator(device=card).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=card) * 2 + 0.5).to(torch.bfloat16)
    k = shape[-1]
    gamma = (1 + 0.1 * torch.randn(k, generator=gen, device=card)).to(torch.bfloat16)
    beta = (0.1 * torch.randn(k, generator=gen, device=card)).to(torch.bfloat16)
    got = _counted("layer_norm_quant",
                   lambda: kernels.layer_norm_quant(x, gamma, beta, 1e-6))
    _assert_int8_close(got, kernels.layer_norm_quant_plain(x, gamma, beta, 1e-6))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("shape", [(16, 257, 6144), (3, 37, 6144), (2, 5, 128)])
def test_gelu_quant_kernel_matches_plain(card, shape, approx):
    gen = torch.Generator(device=card).manual_seed(2)
    x = (torch.randn(shape, generator=gen, device=card) * 2).to(torch.bfloat16)
    got = _counted("gelu_quant", lambda: kernels.gelu_quant(x, approx))
    _assert_int8_close(got, kernels.gelu_quant_plain(x, approx))


def test_packed_qkv_kernel_refuses_what_it_cannot_take(card):
    qkv = torch.zeros((1, 4, 3 * 2 * 88), device=card)
    with pytest.raises(TypeError):
        kernels.packed_qkv_attention(qkv, 2, 88, 0.1)          # fp32
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(qkv.bfloat16()[:, ::2], 2, 88, 0.1)  # strided
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(torch.zeros((1, 4, 3 * 2 * 20), device=card,
                                                 dtype=torch.bfloat16), 2, 20, 0.1)


@pytest.mark.parametrize("kernel", ["quant", "s8"])
def test_packed_int8_kernels_refuse_what_they_cannot_take(card, kernel):
    dtype = torch.bfloat16 if kernel == "quant" else torch.int8
    scales = torch.full((3,), 0.01, device=card)

    def call(t, d=88):
        if kernel == "quant":
            return kernels.packed_qkv_attention_quant(t, 2, d, 0.1)
        return kernels.packed_qkv_attention_s8(t, scales, 2, d, 0.1)

    with pytest.raises(TypeError):
        call(torch.zeros((1, 4, 3 * 2 * 88), device=card))               # fp32
    with pytest.raises(ValueError):
        call(torch.zeros((1, 4, 6 * 2 * 88), device=card, dtype=dtype)[..., ::2])
    with pytest.raises(ValueError):
        call(torch.zeros((1, 4, 3 * 2 * 20), device=card, dtype=dtype), d=20)


@pytest.mark.parametrize("kernel", ["layer_norm", "gelu"])
def test_row_quant_kernels_refuse_what_they_cannot_take(card, kernel):
    ones = torch.ones(64, device=card, dtype=torch.bfloat16)

    def call(x):
        if kernel == "gelu":
            return kernels.gelu_quant(x)
        k = x.shape[-1]
        return kernels.layer_norm_quant(x, ones[:k].contiguous(), ones[:k].contiguous())

    with pytest.raises(TypeError):
        call(torch.zeros((2, 64), device=card))                          # fp32
    with pytest.raises(ValueError):
        call(torch.zeros((2, 128), device=card, dtype=torch.bfloat16)[:, ::2])
    with pytest.raises(ValueError):
        call(torch.zeros((2, 60), device=card, dtype=torch.bfloat16))    # K % 8


@pytest.mark.parametrize("layout", ["column", "row"])
@pytest.mark.parametrize("mkn", [(8, 1408, 4224), (600, 1408, 4224), (52, 64, 64)])
def test_int8_dot_on_the_card_is_exact(card, mkn, layout):
    """The W8A8 product (torch._int_mm on the card, rows padded past 16 for
    decode, the weight column-major as quantize_weights stores it or
    row-major as a converted tree holds it) equals the int64 product of the
    same codes, rounded to fp32 as the reference's int32 -> fp32 cast
    rounds it."""
    from stllm_tpu_torch.ops.quant import _int8_dot

    m, k, n = mkn
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randint(-127, 128, (2, m // 2, k), generator=gen, device=card, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=card, dtype=torch.int8)
    if layout == "column":
        w = w.t().contiguous().t()
    got = _int8_dot(x, w)
    want = (x.cpu().long().reshape(-1, k) @ w.cpu().long()).reshape(2, m // 2, n)
    assert got.dtype == torch.float32 and got.shape == (2, m // 2, n)
    assert torch.equal(got.cpu(), want.float())
