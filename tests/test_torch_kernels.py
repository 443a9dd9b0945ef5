"""PyTorch port, CUDA kernels on the card (marker ``cuda``): each kernel
against its plain PyTorch version at the shapes the video-QA serving and
training paths give it.
Skipped without a CUDA card; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: bf16 attention outputs within the bf16 attention tolerance of
tests/test_ops.py (atol = rtol = 3e-2); the kernel and its plain version
differ only in summation order. The int8 kernels: codes at most one step
apart (an fp32 value at a rounding boundary may round either way), and the
dequantized outputs within the same atol = rtol = 3e-2 (the row kernels
#9 and #10 in fp32, in their "any" form and at every register geometry:
codes at most one step apart in under 1e-3 of them and scales within 1e-5
relative, the CPU tests' tolerance against JAX, since a LayerNorm row's
code step exceeds 3e-2). The
weight-streaming matmuls (W4A16 and the probes): compared in fp32 within
atol = 1e-2 times the plain output's largest magnitude and rtol = 1e-2; the
products are exact, the fp32 sums run in another order (split-K adds its
partials last) and a bf16 output rounds once."""

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


def _assert_int8_within_one_step(got, want):
    """As _assert_int8_close, where a row's scale may exceed atol: at 98
    heads of 128 the attention rows reach amax 8 and more, so one code step
    (the row's scale, above 0.06) is wider than atol = 3e-2; a code that
    lands one step away then counts as within tolerance, by one scale."""
    (gq, gs), (wq, ws) = got, want
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert gq.shape == wq.shape and gs.shape == ws.shape
    assert int((gq.int() - wq.int()).abs().max()) <= 1
    torch.testing.assert_close(gs, ws, atol=0, rtol=INT8_RTOL)
    g, w = gq.float() * gs, wq.float() * ws
    assert bool(((g - w).abs() <= torch.clamp(ws, min=INT8_ATOL) + INT8_RTOL * w.abs()).all())


def _assert_row_codes_close(got, want):
    """#9's and #10's rows: codes at most one step apart in under 1e-3 of
    them (the same fp32 math summed in another order may put a value on the
    other side of a rounding boundary), scales within 1e-5 relative (the
    CPU tests' tolerance against JAX)."""
    (gq, gs), (wq, ws) = got, want
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert gq.shape == wq.shape and gs.shape == ws.shape
    diff = (gq.int() - wq.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    torch.testing.assert_close(gs, ws, atol=0, rtol=1e-5)


def _counted(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


PACKED_SHAPES = [(16, 257, 16, 88), (256, 16, 16, 88), (3, 37, 4, 88),
                 (2, 37, 4, 24), (1, 19, 2, 88), (2, 130, 3, 64), (2, 70, 2, 16)]


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


# head_dim 120 and 128 (#3 took at most 112 before), H*D = 98 x 128 = 12544
# rows wider than a row-quant block's shared memory holds (12256), in the
# short (S <= 16) and long loops, and H*D = 96 x 128 = 12288, just past it:
# shapes the reference's feasibility rule admits
WIDE_SHAPES = [(2, 37, 4, 120), (2, 37, 4, 128), (1, 16, 98, 128), (1, 40, 98, 128),
               (1, 16, 96, 128)]


def _static_int8_qkv(qkv, b, s, h, d):
    qkv = qkv.float()
    scales = (qkv.abs().reshape(b, s, 3, h * d).amax(dim=(0, 1, 3)) / 127.0).contiguous()
    qkv_q = torch.clamp(torch.round(qkv.reshape(b, s, 3, h * d) / scales[:, None]),
                        -127, 127).to(torch.int8).reshape(b, s, 3 * h * d)
    return qkv_q, scales


@pytest.mark.parametrize("kernel", ["packed_qkv_attention", "packed_qkv_attention_quant",
                                    "packed_qkv_attention_s8"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_packed_kernels_at_wide_heads_and_rows(card, shape, kernel):
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d)
    scale = d ** -0.5
    if kernel == "packed_qkv_attention_s8":
        args = (*_static_int8_qkv(qkv, b, s, h, d), h, d, scale)
    else:
        args = (qkv, h, d, scale)
    got = _counted(kernel, lambda: getattr(kernels, kernel)(*args))
    want = getattr(kernels, kernel + "_plain")(*args)
    if kernel == "packed_qkv_attention":
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    else:
        _assert_int8_within_one_step(got, want)


# head_dim the tile loops do not take (not a multiple of 8, or above 128):
# the "any" form, with H*D 39, 40, 108, 272, 600 and 65
ANY_SHAPES = [(2, 37, 3, 13), (1, 40, 2, 20), (2, 19, 3, 36), (1, 33, 2, 136),
              (1, 16, 3, 200), (2, 9, 5, 13)]
ANY_KERNELS = ["packed_qkv_attention", "packed_qkv_attention/fp32",
               "packed_qkv_attention_quant", "packed_qkv_attention_quant/fp32",
               "packed_qkv_attention_s8"]


def _packed_args(card, kernel, shape):
    """(wrapper name, its arguments) for ``kernel`` ("name" or "name/fp32")
    at (B, S, H, D)."""
    b, s, h, d = shape
    name, _, io = kernel.partition("/")
    qkv = _qkv(card, b, s, h, d)
    if name == "packed_qkv_attention_s8":
        return name, (*_static_int8_qkv(qkv, b, s, h, d), h, d, d ** -0.5)
    return name, (qkv.float() if io == "fp32" else qkv, h, d, d ** -0.5)


@pytest.mark.parametrize("kernel", ANY_KERNELS)
@pytest.mark.parametrize("shape", ANY_SHAPES)
def test_packed_kernels_any_form_match_plain(card, shape, kernel):
    assert kernels.packed_form(shape[3]) == "any"
    name, args = _packed_args(card, kernel, shape)
    before = kernels.FORM_LAUNCHES[f"{name}/any"]
    got = _counted(name, lambda: getattr(kernels, name)(*args))
    assert kernels.FORM_LAUNCHES[f"{name}/any"] == before + 1
    want = getattr(kernels, name + "_plain")(*args)
    if name != "packed_qkv_attention":
        _assert_int8_within_one_step(got, want)
    elif got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("kernel", ["packed_qkv_attention", "packed_qkv_attention_quant",
                                    "packed_qkv_attention_s8"])
@pytest.mark.parametrize("head_dim", [88, 128, 20, 136])
def test_packed_call_makes_the_launches_of_its_form(card, kernel, head_dim):
    """One call launches its kernel once, in the form packed_form names and
    no other (FORM_LAUNCHES)."""
    name, args = _packed_args(card, kernel, (2, 37, 3, head_dim))
    forms = dict(kernels.FORM_LAUNCHES)
    _counted(name, lambda: getattr(kernels, name)(*args))
    moved = {k: v - forms[k] for k, v in kernels.FORM_LAUNCHES.items() if v != forms[k]}
    assert moved == {f"{name}/{kernels.packed_form(head_dim)}": 1}


@pytest.mark.parametrize("shape", [(4, 13), (3, 12545), (2, 1408), (5, 7), (3, 12255),
                                   (3, 12256), (3, 12257), (3, 12287), (3, 12288)])
def test_row_quant_pass_at_any_width(card, shape):
    """The row-quant pass of #2 and #3 alone at row widths that are no
    multiple of 8 (13: staged, element by element; 12545: read from device
    memory twice) and either side of the widest staged row (12256: the fp32
    row and the reduction's 128 bytes fill the 48 KB of shared memory a
    block gets without an opt-in)."""
    gen = torch.Generator(device=card).manual_seed(4)
    y = torch.randn(shape, generator=gen, device=card) * 3
    y[0] = 0.0                                       # amax 0: scale 1, codes 0
    got = kernels._rowwise_quant_pass(y)
    torch.cuda.synchronize()
    _assert_int8_within_one_step(got, kernels.rowwise_quant_plain(y))
    assert float(got[1][0]) == 1.0 and not bool(got[0][0].any())


@pytest.mark.parametrize("shape", [(1, 16, 98, 128), (2, 19, 100, 128)])
def test_wide_row_quant_pass_matches_plain_in_fp32(card, shape):
    """#1 and #2's fp32 instantiations at H*D above 12288: the wide
    row-quant pass on fp32 attention rows."""
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d).float()
    got = _counted("packed_qkv_attention_quant",
                   lambda: kernels.packed_qkv_attention_quant(qkv, h, d, d ** -0.5))
    _assert_int8_within_one_step(
        got, kernels.packed_qkv_attention_quant_plain(qkv, h, d, d ** -0.5))
    got = _counted("packed_qkv_attention",
                   lambda: kernels.packed_qkv_attention(qkv, h, d, d ** -0.5))
    torch.testing.assert_close(got, kernels.packed_qkv_attention_plain(qkv, h, d, d ** -0.5),
                               atol=1e-5, rtol=1e-4)


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
        kernels.packed_qkv_attention(qkv.half(), 2, 88, 0.1)   # fp16
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(qkv.bfloat16()[:, ::2], 2, 88, 0.1)  # strided
    for s, d in ((4, 0), (1024, 20)):             # no head; the "any" form's S <= 1023
        with pytest.raises(ValueError):
            kernels.packed_qkv_attention(torch.zeros((1, s, 3 * 2 * d), device=card,
                                                     dtype=torch.bfloat16), 2, d, 0.1)


@pytest.mark.parametrize("kernel", ["quant", "s8"])
def test_packed_int8_kernels_refuse_what_they_cannot_take(card, kernel):
    dtype = torch.bfloat16 if kernel == "quant" else torch.int8
    scales = torch.full((3,), 0.01, device=card)

    def call(t, d=88):
        if kernel == "quant":
            return kernels.packed_qkv_attention_quant(t, 2, d, 0.1)
        return kernels.packed_qkv_attention_s8(t, scales, 2, d, 0.1)

    with pytest.raises(TypeError):   # fp16; #3 takes int8 only
        call(torch.zeros((1, 4, 3 * 2 * 88), device=card,
                         dtype=torch.float16 if kernel == "quant" else torch.float32))
    with pytest.raises(ValueError):
        call(torch.zeros((1, 4, 6 * 2 * 88), device=card, dtype=dtype)[..., ::2])
    with pytest.raises(ValueError):
        call(torch.zeros((1, 4, 0), device=card, dtype=dtype), d=0)
    with pytest.raises(ValueError):
        call(torch.zeros((1, 1024, 3 * 2 * 20), device=card, dtype=dtype), d=20)


@pytest.mark.parametrize("kernel", ["layer_norm", "gelu"])
def test_row_quant_kernels_refuse_what_they_cannot_take(card, kernel):
    ones = torch.ones(64, device=card, dtype=torch.bfloat16)

    def call(x, params=ones):
        if kernel == "gelu":
            return kernels.gelu_quant(x)
        k = x.shape[-1]
        return kernels.layer_norm_quant(x, params[:k].contiguous(), params[:k].contiguous())

    with pytest.raises(TypeError):
        call(torch.zeros((2, 64), device=card, dtype=torch.float16))    # fp16
    with pytest.raises(ValueError):
        call(torch.zeros((2, 128), device=card, dtype=torch.bfloat16)[:, ::2])
    if kernel == "layer_norm":
        with pytest.raises(TypeError):                                   # fp16 params
            call(torch.zeros((2, 64), device=card, dtype=torch.bfloat16), ones.half())


def _row_inputs(card, shape, dtype, seed, params_dtype=None):
    """x ~ N(0.5, 2) and (for #9) gamma around 1, beta around 0."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=card) * 2 + 0.5).to(dtype)
    k = shape[-1]
    gamma = (1 + 0.1 * torch.randn(k, generator=gen, device=card)).to(params_dtype or dtype)
    beta = (0.1 * torch.randn(k, generator=gen, device=card)).to(params_dtype or dtype)
    return x, gamma, beta


def _row_call(kernel, x, gamma, beta, form=None):
    """The kernel (in ``form``, else the rule's) and its plain version."""
    if kernel == "layer_norm":
        return (kernels._layer_norm_quant(x, gamma, beta, 1e-6, form),
                kernels.layer_norm_quant_plain(x, gamma, beta, 1e-6))
    approx = kernel == "gelu-tanh"
    return kernels._gelu_quant(x, approx, form), kernels.gelu_quant_plain(x, approx)


@pytest.mark.parametrize("params_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["layer_norm", "gelu-erf", "gelu-tanh"])
@pytest.mark.parametrize("shape", [(16, 257, 1408), (16, 257, 6144)])
def test_row_quant_kernels_take_fp32(card, shape, kernel, params_dtype):
    """fp32 rows (an fp32 model's LayerNorm and GELU) in the register form,
    #9 with fp32 and with bf16 gamma and beta; the params are read as they
    are, never cast."""
    if kernel != "layer_norm" and params_dtype == torch.bfloat16:
        pytest.skip("GELU has no params")
    x, gamma, beta = _row_inputs(card, shape, torch.float32, 5, params_dtype)
    name = "layer_norm_quant" if kernel == "layer_norm" else "gelu_quant"
    before = kernels.FORM_LAUNCHES[f"{name}/registers"]
    got, want = _row_call(kernel, x, gamma, beta)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES[f"{name}/registers"] == before + 1
    _assert_row_codes_close(got, want)


# row widths the register form does not take: bf16 K % 8 != 0 (13, 1412;
# 12255, the widest row the "any" form stages in shared memory, and 12285,
# 12287, just past it), rows wider than 12288 (12296, 16384); fp32 at the
# same widths but 1412 (whole 16-byte chunks: the register form)
ANY_ROWS = [(3, 5, 13), (2, 37, 1412), (2, 3, 12255), (2, 3, 12285), (2, 3, 12287),
            (2, 3, 12296), (2, 3, 16384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["layer_norm", "gelu-erf", "gelu-tanh"])
@pytest.mark.parametrize("shape", ANY_ROWS)
def test_row_quant_kernels_any_form_match_plain(card, shape, kernel, dtype):
    want_form = kernels.row_quant_form(shape[-1], dtype)
    x, gamma, beta = _row_inputs(card, shape, dtype, 6)
    name = "layer_norm_quant" if kernel == "layer_norm" else "gelu_quant"
    before = kernels.FORM_LAUNCHES[f"{name}/{want_form}"]
    got, want = _row_call(kernel, x, gamma, beta)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES[f"{name}/{want_form}"] == before + 1
    assert want_form == ("registers" if (dtype, shape[-1]) == (torch.float32, 1412) else "any")
    _assert_row_codes_close(got, want)


# one K for each register geometry (threads a row, groups of 8 a thread):
# one warp at G = 1..6, then 2, 4 and 8 warps at G = 4, 5, 6
GEOMETRY_K = [8, 264, 520, 1024, 1032, 1408, 1544, 2056, 3072, 3080, 4104, 6144, 6152,
              8200, 12288]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", GEOMETRY_K)
def test_row_quant_register_form_at_every_geometry(card, k, dtype):
    """#9 and #10 (both GELU forms) at a K of each register geometry, with
    ragged row counts (the last block part empty)."""
    x, gamma, beta = _row_inputs(card, (3, 7, k), dtype, 7)
    assert kernels.row_quant_form(k, dtype) == "registers"
    for kernel in ("layer_norm", "gelu-erf", "gelu-tanh"):
        got, want = _row_call(kernel, x, gamma, beta)
        _assert_row_codes_close(got, want)


@pytest.fixture(scope="module")
def divide_check():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    import chip_smoke

    return chip_smoke.build_divide_check(kernels)


def test_row_divide_matches_fdiv_rn(card, divide_check):
    """The register form divides a row's values by its scale through the
    row's reciprocal with one fused correction (rowwise_quant.cuh:
    div_rn_by). Exhaustive where a code can change: for every scale
    mantissa, every code boundary (k + 1/2) s, k = 0..127, and the 16 fp32
    values either side of it, both signs, the quotient and its code equal
    __fdiv_rn's (script/row_divide_check.cu; rowwise_quant.cuh says why
    that covers every row whose scale lies in [2^-64, 2^64])."""
    assert divide_check(16) == (0, 0)


@pytest.mark.parametrize("kernel", ["layer_norm", "gelu-erf"])
@pytest.mark.parametrize("k", [1408, 6144])
def test_row_quant_forms_agree(card, k, kernel):
    """The "any" form forced at a width the register form takes gives the
    same codes within one step (the same fp32 math summed in another order)."""
    x, gamma, beta = _row_inputs(card, (4, 33, k), torch.bfloat16, 8)
    name = "layer_norm_quant" if kernel == "layer_norm" else "gelu_quant"
    before = {f: kernels.FORM_LAUNCHES[f"{name}/{f}"] for f in ("registers", "any")}
    regs, _ = _row_call(kernel, x, gamma, beta)
    anyf, _ = _row_call(kernel, x, gamma, beta, form="any")
    torch.cuda.synchronize()
    assert {f: kernels.FORM_LAUNCHES[f"{name}/{f}"] - before[f] for f in before} == \
        {"registers": 1, "any": 1}
    _assert_row_codes_close(regs, anyf)
    with pytest.raises(ValueError):       # no register form for K % 8 != 0 in bf16
        _row_call(kernel, x[..., :k - 4].contiguous(), gamma[:k - 4].contiguous(),
                  beta[:k - 4].contiguous(), form="registers")


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


# --------------------------------------------------------------------------
# weight-streaming matmuls: W4A16 (#12) and the probes #13-#15
# --------------------------------------------------------------------------

WS_TOL = 1e-2


def _assert_ws_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    torch.testing.assert_close(g, w, atol=WS_TOL * float(w.abs().max()), rtol=WS_TOL)


def _ws_inputs(card, m, k, n, seed, *, pad=0, dtype=torch.bfloat16):
    """x (m, k); random bytes (k/2 + pad, n) whose padded rows are zero;
    per-channel scales of a 0.02-std weight's int4 codes."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=card).to(dtype)
    packed = torch.randint(-128, 128, (k // 2 + pad, n), generator=gen, device=card,
                           dtype=torch.int8)
    packed[k // 2:] = 0
    scale = (0.02 * 3 / 7) * (0.5 + torch.rand(n, generator=gen, device=card))
    return x, packed, scale


# (m, K, N, padded packed rows, x dtype): the decode and prefill shapes of the
# W4A16 stack, the K-padded down projection (5504 -> 5632 packed rows), a
# ragged N tile with 8-byte weight rows, and an fp32 x; then the wgmma form
# (M > 16): the pipeline prompt (640 = 5 x 128), ragged M (17, 200), the
# QA prompt's gate|up, an fp32 x, the padded down projection at M = 576,
# and K/2 (40) not a multiple of the 64-row stage
W4_CASES = [(4, 4096, 12288, 0, torch.bfloat16), (4, 11008, 4096, 128, torch.bfloat16),
            (1, 4096, 4096, 0, torch.bfloat16), (16, 4096, 22016, 0, torch.bfloat16),
            (576, 4096, 4096, 0, torch.bfloat16), (576, 11008, 4096, 128, torch.bfloat16),
            (20, 80, 200, 0, torch.bfloat16), (3, 96, 136, 5, torch.float32),
            (640, 4096, 12288, 0, torch.bfloat16), (17, 4096, 4096, 0, torch.bfloat16),
            (200, 4096, 4096, 0, torch.bfloat16), (576, 4096, 22016, 0, torch.bfloat16),
            (100, 4096, 4096, 0, torch.float32), (576, 11008, 4096, 128, torch.float32),
            (33, 80, 136, 3, torch.bfloat16)]


@pytest.mark.parametrize("case", W4_CASES, ids=lambda c: f"m{c[0]}-k{c[1]}-n{c[2]}-pad{c[3]}")
def test_w4a16_kernel_matches_plain(card, case):
    m, k, n, pad, dtype = case
    x, packed, scale = _ws_inputs(card, m, k, n, 4, pad=pad, dtype=dtype)
    got = _counted("w4a16_matmul", lambda: kernels.w4a16_matmul(x, packed, scale))
    _assert_ws_close(got, kernels.w4a16_matmul_plain(x, packed, scale))


@pytest.mark.parametrize("m", [17, 576, 640])
def test_w4a16_forms_agree(card, m):
    """At M > 16 the wgmma form and the tile loop (the design it replaced)
    give the same product."""
    x, packed, scale = _ws_inputs(card, m, 4096, 4096, 14)
    wgmma = kernels._w4a16_matmul(x, packed, scale, "wgmma")
    _assert_ws_close(wgmma, kernels._w4a16_matmul(x, packed, scale, "stream"))


# the decode form (M <= 16): the Vicuna-7B shapes (K, N, padded packed rows;
# down's K/2 = 5504 stored as 5632 rows) at every row count up to 16 that
# splits the n8 tiles differently, then a ragged N (200: a multiple of 8,
# not of 16 or 64, so 8-byte weight copies and a part-filled column tile)
# and an fp32 x
W4_DECODE_SHAPES = [(4096, 12288, 0), (4096, 4096, 0), (4096, 22016, 0), (11008, 4096, 128)]
W4_DECODE_CASES = ([(m, k, n, pad, torch.bfloat16) for m in (1, 3, 4, 8, 16)
                    for k, n, pad in W4_DECODE_SHAPES]
                   + [(4, 80, 200, 0, torch.bfloat16), (13, 336, 200, 8, torch.bfloat16),
                      (4, 4096, 12288, 0, torch.float32), (9, 11008, 4096, 128, torch.float32)])


@pytest.mark.parametrize("case", W4_DECODE_CASES,
                         ids=lambda c: f"m{c[0]}-k{c[1]}-n{c[2]}-pad{c[3]}-{str(c[4])[6:]}")
def test_w4a16_decode_form_matches_plain(card, case):
    m, k, n, pad, dtype = case
    assert kernels.w4a16_form(m) == "decode"
    x, packed, scale = _ws_inputs(card, m, k, n, 15, pad=pad, dtype=dtype)
    before = dict(kernels.FORM_LAUNCHES)
    got = _counted("w4a16_matmul", lambda: kernels.w4a16_matmul(x, packed, scale))
    assert kernels.FORM_LAUNCHES["w4a16_matmul/decode"] == before["w4a16_matmul/decode"] + 1
    _assert_ws_close(got, kernels.w4a16_matmul_plain(x, packed, scale))


@pytest.mark.parametrize("m", [1, 4, 16])
def test_w4a16_decode_form_and_tile_loop_agree(card, m):
    """The decode form and the tile loop it replaced (split-K at these
    shapes) give the same product, and the tile loop, kept as the timed
    parent, still gives the plain one."""
    for k, n, pad in W4_DECODE_SHAPES:
        x, packed, scale = _ws_inputs(card, m, k, n, 16, pad=pad)
        stream = kernels._w4a16_matmul(x, packed, scale, "stream")
        _assert_ws_close(stream, kernels.w4a16_matmul_plain(x, packed, scale))
        _assert_ws_close(kernels._w4a16_matmul(x, packed, scale, "decode"), stream)


# (K, N, expected CTAs along K): the decode form's rule (cluster_size in
# csrc/w4a16_decode.cuh) doubles the CTAs of a cluster until a call has 512
# CTAs, at most 16 and at most the 16-row steps of K/2. So 512 column tiles
# take 1, 256 take 2, a few steps (K/2 = 48, 80, 112) take 3, 5 or 7, 64 tiles
# take 8, and down's 344 steps, uneven at 16, take 16.
W4_DECODE_CLUSTERS = [(512, 65536, 1), (512, 32768, 2), (96, 4096, 3), (160, 4096, 5),
                      (224, 4096, 7), (11008, 8192, 8), (11008, 4096, 16)]


@pytest.mark.parametrize("case", W4_DECODE_CLUSTERS, ids=lambda c: f"k{c[0]}-n{c[1]}-c{c[2]}")
def test_w4a16_decode_form_at_every_cluster_size(card, case):
    """K split over 1 to 16 CTAs of a cluster, summed through distributed
    shared memory: each size the rule gives, whole or uneven shares of the
    steps, gives the plain product at one and two n8 tiles of rows."""
    k, n, _ = case
    for m in (4, 12):
        x, packed, scale = _ws_inputs(card, m, k, n, 17, pad=128 if k == 11008 else 0)
        got = kernels.w4a16_matmul(x, packed, scale)
        _assert_ws_close(got, kernels.w4a16_matmul_plain(x, packed, scale))


def test_w4a16_decode_form_is_one_launch(card):
    """One call of the decode form is one launch and nothing of the tile
    loop, at the shapes where the tile loop split K into a second launch."""
    for k, n, pad in W4_DECODE_SHAPES:
        x, packed, scale = _ws_inputs(card, 4, k, n, 18, pad=pad)
        assert kernels.weight_stream_splits(4, n, k // 2) > 1
        before, forms = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
        kernels.w4a16_matmul(x, packed, scale)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["w4a16_matmul"] == before["w4a16_matmul"] + 1
        assert {f: kernels.FORM_LAUNCHES[f] - forms[f] for f in forms} == {
            f: int(f == "w4a16_matmul/decode") for f in forms}


def test_w4a16_decode_form_refuses_more_than_16_rows(card):
    x, packed, scale = _ws_inputs(card, 17, 64, 64, 19)
    with pytest.raises(ValueError):
        kernels._w4a16_matmul(x, packed, scale, "decode")


# the probes' decoder shapes at M = 1 (down's K padded 11008 -> 11264 as the
# probe pads it), and a small ragged one
PROBE_SHAPES = [(1, 4096, 4096), (1, 4096, 11008), (1, 11264, 4096), (5, 48, 72)]


def _codes(card, shape, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(-7, 8, shape, generator=gen, device=card, dtype=torch.int8)


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_w4v3_kernel_matches_plain(card, shape):
    m, k, n = shape
    x, _, scale = _ws_inputs(card, m, k, n, 5)
    packed = kernels.pack_int4_arith(_codes(card, (k // 2, n), 6), _codes(card, (k // 2, n), 7))
    got = _counted("w4v3_matmul", lambda: kernels.w4v3_matmul(x, packed, scale))
    want = kernels.w4v3_matmul_plain(x, packed, scale)
    _assert_ws_close(got, want)
    # the same codes in the nibble layout give kernel #12's product
    nib = kernels.pack_int4_nibbles(_codes(card, (k // 2, n), 6), _codes(card, (k // 2, n), 7))
    _assert_ws_close(kernels.w4a16_matmul_plain(x, nib, scale), want)


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_w8p_kernel_matches_plain(card, shape):
    m, k, n = shape
    x, _, scale = _ws_inputs(card, m, k, n, 8)
    gen = torch.Generator(device=card).manual_seed(9)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=card, dtype=torch.int8)
    got = _counted("w8p_matmul", lambda: kernels.w8p_matmul(x, w, scale * 7 / 127))
    _assert_ws_close(got, kernels.w8p_matmul_plain(x, w, scale * 7 / 127))


@pytest.mark.parametrize("variant", kernels.W4_UNPACK_VARIANTS)
def test_w4_unpack_kernel_matches_plain(card, variant):
    """The probe's shape, x (16, 4096) and packed (2048, 11008): each
    variant on its layout gives the same product as its plain version and
    as the nibble layout's plain product."""
    m, k, n = 16, 4096, 11008
    x = torch.randn(m, k, generator=torch.Generator(device=card).manual_seed(10),
                    device=card).mul(0.1).bfloat16()
    top, bot = _codes(card, (k // 2, n), 11), _codes(card, (k // 2, n), 12)
    pack = kernels.pack_int4_biased if variant in kernels.BIASED_VARIANTS else \
        kernels.pack_int4_nibbles
    packed = pack(top, bot)
    got = _counted("w4_unpack_matmul", lambda: kernels.w4_unpack_matmul(x, packed, variant))
    assert got.dtype == torch.float32
    _assert_ws_close(got, kernels.w4_unpack_matmul_plain(x, packed, variant))
    _assert_ws_close(got, kernels.w4_unpack_matmul_plain(x, kernels.pack_int4_nibbles(top, bot),
                                                         "int32"))


# #15's widths on both forms: the probe's, N % 8 != 0, odd K/2
UNPACK_WIDTHS = [(4096, 11008), (512, 20), (202, 20), (8, 12), (1024, 100), (2050, 500)]


def _unpack_inputs(card, m, k, n, seed):
    """x (m, k) and each variant's packing of the same int4 codes."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(m, k, generator=gen, device=card) * 0.1).bfloat16()
    top, bot = (torch.randint(-7, 8, (k // 2, n), generator=gen, device=card, dtype=torch.int8)
                for _ in range(2))
    return x, {v: kernels.pack_int4_variant(v, top, bot) for v in kernels.W4_UNPACK_VARIANTS}


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17])
@pytest.mark.parametrize("kn", UNPACK_WIDTHS, ids=lambda kn: f"k{kn[0]}-n{kn[1]}")
def test_w4_unpack_variants_on_their_forms_match_plain(card, kn, m):
    """#15's five variants run #12's decode form at M <= 8 and the tile loop
    above, one launch of that form each, and each gives its plain product;
    the decode form, asked for, gives it too up to 16 rows; every variant
    gives the same product (their layouts hold the same codes)."""
    x, packed = _unpack_inputs(card, m, *kn, 27)
    form = kernels.unpack_form(m)
    products = []
    for variant in kernels.W4_UNPACK_VARIANTS:
        before = dict(kernels.FORM_LAUNCHES)
        got = _counted("w4_unpack_matmul",
                       lambda: kernels.w4_unpack_matmul(x, packed[variant], variant))
        assert {f: kernels.FORM_LAUNCHES[f] - before[f] for f in before} == {
            f: int(f == f"w4_unpack_matmul/{form}") for f in before}
        assert got.dtype == torch.float32 and got.shape == (m, kn[1])
        want = kernels.w4_unpack_matmul_plain(x, packed[variant], variant)
        _assert_ws_close(got, want)
        if form != "decode" and m <= kernels.W4_DECODE_ROWS:
            _assert_ws_close(kernels._w4_unpack_matmul(x, packed[variant], variant, "decode"),
                             want)
        products.append(got)
    for got in products[1:]:
        _assert_ws_close(got, products[0])


def test_w4_unpack_forms_agree_and_repeat(card):
    """At the probe's shape each variant's decode form and tile loop give
    the same product, and the decode form the same bits on two runs (the
    cluster's sums in rank order, the row correction folded before them)."""
    x, packed = _unpack_inputs(card, 16, 4096, 11008, 28)
    for variant in kernels.W4_UNPACK_VARIANTS:
        dec = kernels._w4_unpack_matmul(x, packed[variant], variant, "decode")
        _assert_ws_close(dec, kernels._w4_unpack_matmul(x, packed[variant], variant, "stream"))
        assert torch.equal(kernels._w4_unpack_matmul(x, packed[variant], variant, "decode"), dec)


# the widths the reference takes that no multiple of 8 is: (K, N) of the
# probes (N 20, 100, 500, 12) and of #12 (K/2 100 and 4 as well)
ODD_WIDTHS = [(512, 20), (512, 100), (512, 500), (1024, 12), (200, 20), (8, 12)]
PROBE_KERNELS = {"w4v3_matmul": (kernels.w4v3_matmul, kernels.w4v3_matmul_plain),
                 "w8p_matmul": (kernels.w8p_matmul, kernels.w8p_matmul_plain)}


def _probe_inputs(card, name, m, k, n, seed, dtype=torch.bfloat16):
    """x (m, k); #13's packed bytes (k/2, n) or #14's codes (k, n), each
    drawn from all of -128..127 (both kernels take any byte); scales of a
    0.02-std weight's codes."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=card).to(dtype)
    rows = k // 2 if name == "w4v3_matmul" else k
    w = torch.randint(-128, 128, (rows, n), generator=gen, device=card, dtype=torch.int8)
    scale = (0.02 * 3 / 127) * (0.5 + torch.rand(n, generator=gen, device=card))
    return x, w, scale


@pytest.mark.parametrize("m", [1, 3, 8, 16, 17])
@pytest.mark.parametrize("kn", [(k, n) for _, k, n in PROBE_SHAPES] + ODD_WIDTHS,
                         ids=lambda kn: f"k{kn[0]}-n{kn[1]}")
@pytest.mark.parametrize("name", sorted(PROBE_KERNELS))
def test_probe_kernels_on_their_forms_match_plain(card, name, kn, m):
    """#13 and #14 run #12's decode form at M <= 16 and the tile loop at 17,
    one launch of that form each, at the probe's decoder shapes and at N
    and K no multiple of 8 or of 128, and give their plain products."""
    kernel, plain = PROBE_KERNELS[name]
    x, w, scale = _probe_inputs(card, name, m, *kn, 23)
    form = kernels.probe_form(m)
    assert form == ("decode" if m <= 16 else "stream")
    before = dict(kernels.FORM_LAUNCHES)
    got = _counted(name, lambda: kernel(x, w, scale))
    assert {f: kernels.FORM_LAUNCHES[f] - before[f] for f in before} == {
        f: int(f == f"{name}/{form}") for f in before}
    _assert_ws_close(got, plain(x, w, scale))


@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("name", sorted(PROBE_KERNELS))
def test_probe_decode_form_takes_fp32(card, name, m):
    """An fp32 x (multiplied as bf16) gives an fp32 output on the decode
    form, as the plain version."""
    kernel, plain = PROBE_KERNELS[name]
    x, w, scale = _probe_inputs(card, name, m, 4096, 4096, 24, torch.float32)
    got = kernel(x, w, scale)
    assert got.dtype == torch.float32
    _assert_ws_close(got, plain(x, w, scale))


def test_w4v3_decode_form_is_exact_on_every_byte(card):
    """Every byte value of the arithmetic layout, picked out by one-hot rows
    of x at unit scale, on both forms: the top and bottom codes exactly as
    the plain version (and the reference) round them, half to even."""
    k2, n = 256, 16
    p = ((torch.arange(k2 * n, device=card) % 256) - 128).to(torch.int8).reshape(k2, n)
    eye = torch.eye(2 * k2, device=card)
    one = torch.ones(n, device=card)
    want = kernels.w4v3_matmul_plain(eye, p, one)
    assert set(p.unique().tolist()) == set(range(-128, 128))
    for rows in range(0, 2 * k2, 16):
        for form in ("decode", "stream"):
            got = kernels._w4v3_matmul(eye[rows:rows + 16], p, one, form)
            assert torch.equal(got, want[rows:rows + 16]), (rows, form)


def test_w8p_decode_form_is_exact_on_the_full_int8_range(card):
    """Every int8 code, picked out by one-hot rows of x at unit scale, on
    both forms: each code converted exactly."""
    k, n = 256, 16
    w = ((torch.arange(k * n, device=card) % 256) - 128).to(torch.int8).reshape(k, n)
    eye = torch.eye(k, device=card)
    one = torch.ones(n, device=card)
    for rows in range(0, k, 16):
        for form in ("decode", "stream"):
            got = kernels._w8p_matmul(eye[rows:rows + 16], w, one, form)
            assert torch.equal(got, w[rows:rows + 16].float()), (rows, form)


@pytest.mark.parametrize("name", sorted(PROBE_KERNELS) + ["w4a16_matmul"])
def test_decode_form_gives_the_same_output_on_two_runs(card, name):
    """The cluster's sums run in rank order: two runs of the decode form on
    the same inputs give the same bits, at down's 16 CTAs along K."""
    k, n = 11264, 4096
    if name == "w4a16_matmul":
        x, packed, scale = _ws_inputs(card, 4, k, n, 25)
        first = kernels.w4a16_matmul(x, packed, scale)
        assert torch.equal(kernels.w4a16_matmul(x, packed, scale), first)
        return
    kernel, _ = PROBE_KERNELS[name]
    x, w, scale = _probe_inputs(card, name, 4, k, n, 25)
    first = kernel(x, w, scale)
    assert torch.equal(kernel(x, w, scale), first)


# #12 at the odd widths: (M, K, N, stored padded rows) on each form, the
# stored K-padding rows the reference's storage rule gives (512 rows at K/2 =
# 100 and 4) and none
W4_ODD = [(200, 20, 0), (200, 20, 412), (8, 12, 0), (8, 12, 508), (512, 100, 0),
          (512, 500, 0), (1024, 12, 0)]


@pytest.mark.parametrize("form,m", [("decode", 1), ("decode", 16), ("wgmma", 17),
                                    ("wgmma", 200), ("stream", 3), ("stream", 70)])
@pytest.mark.parametrize("case", W4_ODD, ids=lambda c: f"k{c[0]}-n{c[1]}-pad{c[2]}")
def test_w4a16_at_odd_widths_on_every_form(card, case, form, m):
    """#12 at N = 20, 100, 500, 12 and K/2 = 100, 4 (padded to multiples of
    8 by the wrapper, with the stored padding rows where they exist) on
    each form gives the plain product; the rule picks the form it is given
    here at these M."""
    k, n, pad = case
    x, packed, scale = _ws_inputs(card, m, k, n, 26, pad=pad)
    if form != "stream":
        assert kernels.w4a16_form(m) == form
    before = kernels.FORM_LAUNCHES[f"w4a16_matmul/{form}"]
    got = kernels._w4a16_matmul(x, packed, scale, form)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES[f"w4a16_matmul/{form}"] == before + 1
    _assert_ws_close(got, kernels.w4a16_matmul_plain(x, packed, scale))


def test_weight_stream_kernels_refuse_what_they_cannot_take(card):
    x, packed, scale = _ws_inputs(card, 4, 64, 64, 13)
    with pytest.raises(TypeError):
        kernels.w4a16_matmul(x.half(), packed, scale)                     # fp16 x
    with pytest.raises(TypeError):
        kernels.w4a16_matmul(x, packed.int(), scale)                      # int32 weight
    with pytest.raises(ValueError):
        kernels.w4a16_matmul(x[:, :63], packed, scale)                    # odd K
    with pytest.raises(ValueError):
        kernels.w4a16_matmul(x, packed[:16].contiguous(), scale)          # rows < K/2
    with pytest.raises(ValueError):
        kernels.w4a16_matmul(x, packed[:, ::2], scale[::2].contiguous())  # strided
    with pytest.raises(ValueError):
        kernels.w4a16_matmul(x, packed, scale[:32].contiguous())          # scale shape
    with pytest.raises(ValueError):
        kernels.w4_unpack_matmul(x, packed, "int4")                       # no such variant
    x17, w, s = _probe_inputs(card, "w8p_matmul", 17, 64, 64, 13)
    with pytest.raises(ValueError):
        kernels._w4_unpack_matmul(x17, packed, "int32", "decode")         # 17 rows
    with pytest.raises(ValueError):
        kernels._w8p_matmul(x17, w, s, "decode")                          # 17 rows
    with pytest.raises(ValueError):
        kernels.w8p_matmul(x17, w[:32].contiguous(), s)                   # rows < K
    # N and K/2 no multiple of 8 are padded, not refused (the reference
    # takes them): the plain product
    _assert_ws_close(kernels.w4a16_matmul(x, packed[:, :60].contiguous(), scale[:60]),
                     kernels.w4a16_matmul_plain(x, packed[:, :60], scale[:60]))
    _assert_ws_close(kernels.w4a16_matmul(x[:, :60], packed, scale),
                     kernels.w4a16_matmul_plain(x[:, :60], packed, scale))


# ---------------------------------------------------------------------------
# the training path's attention: fused short (#7), flash forward (#4) and
# backward (#5, #6), and the packed kernel's backward. Tolerance as #1:
# atol = rtol = 3e-2 in bf16 (the kernels round P and dS to bf16 for their
# second product; the plain versions keep them as the TPU kernels do).
# ---------------------------------------------------------------------------

def _attn_inputs(card, b, sq, sk, h, d, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, d, generator=gen, device=card).bfloat16()  # noqa: E731
    kv_mask = torch.ones(b, sk, dtype=torch.int32, device=card)
    kv_mask[-1, sk - sk // 5:] = 0
    return mk(sq), mk(sk), mk(sk), kv_mask, mk(sq)


def _close_bf16(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


FUSED_SHAPES = [(1, 768, 768, 32, 128), (16, 257, 257, 16, 88), (2, 100, 100, 2, 32),
                (2, 70, 130, 3, 64), (2, 130, 70, 3, 64), (1, 1000, 1000, 2, 24)]


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_short_kernel_matches_plain(card, shape, causal, masked):
    b, sq, sk, h, d = shape
    q, k, v, kv_mask, _ = _attn_inputs(card, b, sq, sk, h, d)
    kv_mask = kv_mask if masked else None
    got = _counted("fused_short_attention",
                   lambda: kernels.fused_short_attention(q, k, v, kv_mask, causal, d ** -0.5))
    _close_bf16(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, causal, d ** -0.5))


def test_fused_short_kernel_rows_without_a_visible_key(card):
    """A batch row whose keys are all masked averages v over every key, as
    the max-subtracted softmax over -1e30 scores does, also under the causal
    tile skip; strided q, k, v (a packed projection viewed as heads) are
    read in place."""
    b, s, h, d = 2, 200, 4, 88
    gen = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=card).bfloat16()
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
    kv_mask = torch.ones(b, s, dtype=torch.int32, device=card)
    kv_mask[1] = 0
    for causal in (False, True):
        got = kernels.fused_short_attention(q, k, v, kv_mask, causal, 0.1)
        _close_bf16(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, causal, 0.1))
        _close_bf16(got[1], v[1].float().mean(dim=0, keepdim=True).expand(s, h, d))


# the last two: lengths that are no multiple of the backward's 64-row walked
# tile
FLASH_SHAPES = [(1, 1024, 32, 128), (2, 1100, 2, 88), (16, 257, 16, 88), (2, 100, 2, 32),
                (1, 2048, 4, 128), (1, 1000, 4, 128), (2, 70, 2, 64)]


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels_match_plain(card, shape, causal, masked):
    b, s, h, d = shape
    q, k, v, kv_mask, g = _attn_inputs(card, b, s, s, h, d, seed=2)
    kv_mask = kv_mask if masked else None
    scale = d ** -0.5
    out, lse = _counted("flash_attention_fwd",
                        lambda: kernels.flash_attention_fwd(q, k, v, kv_mask, causal, scale))
    want_out, want_lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    _close_bf16(out, want_out)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    delta = (g.float() * want_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = _counted("flash_attention_bwd_dq", lambda: kernels.flash_attention_bwd_dq(
        q, k, v, kv_mask, g, want_lse, delta, causal, scale))
    dk, dv = _counted("flash_attention_bwd_dkv", lambda: kernels.flash_attention_bwd_dkv(
        q, k, v, kv_mask, g, want_lse, delta, causal, scale))
    for got, want in zip((dq, dk, dv), kernels.flash_attention_bwd_plain(
            q, k, v, kv_mask, g, want_lse, delta, causal, scale)):
        _close_bf16(got, want)


def _backward_vs_plain(q, k, v, kv_mask, g, causal, scale):
    """#5 and #6 against the plain backward, from the plain forward's lse;
    returns the kernels' dk, dv."""
    want_out, lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    delta = (g.float() * want_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = _counted("flash_attention_bwd_dq", lambda: kernels.flash_attention_bwd_dq(
        q, k, v, kv_mask, g, lse, delta, causal, scale))
    dk, dv = _counted("flash_attention_bwd_dkv", lambda: kernels.flash_attention_bwd_dkv(
        q, k, v, kv_mask, g, lse, delta, causal, scale))
    for got, want in zip((dq, dk, dv), kernels.flash_attention_bwd_plain(
            q, k, v, kv_mask, g, lse, delta, causal, scale)):
        _close_bf16(got, want)
    return dk, dv


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_with_whole_walked_tiles_masked(card, causal):
    """A kv_mask that hides keys 64-191 in every batch row: two whole 64-key
    tiles dQ walks, and the whole key block of one dK, dV block, whose
    gradients are then 0."""
    b, s, h, d = 2, 320, 2, 128
    q, k, v, kv_mask, g = _attn_inputs(card, b, s, s, h, d, seed=5)
    kv_mask[:, 64:192] = 0
    dk, dv = _backward_vs_plain(q, k, v, kv_mask, g, causal, d ** -0.5)
    assert not bool(dk[:, 64:192].any()) and not bool(dv[:, 64:192].any())


@pytest.mark.parametrize("causal,masked", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("sq,sk", [(70, 130), (130, 70), (300, 200), (1000, 1100)])
def test_flash_backward_kernels_with_more_or_fewer_keys(card, sq, sk, causal, masked):
    """Sk != Sq through the wrappers (causal: key <= query, no offset)."""
    b, h, d = 2, 2, 64
    q, k, v, kv_mask, g = _attn_inputs(card, b, sq, sk, h, d, seed=6)
    _backward_vs_plain(q, k, v, kv_mask if masked else None, g, causal, d ** -0.5)


def test_flash_kernel_rows_without_a_visible_key(card):
    b, s, h, d = 2, 96, 2, 64
    q, k, v, kv_mask, g = _attn_inputs(card, b, s, s, h, d, seed=3)
    kv_mask[1] = 0
    out, lse = kernels.flash_attention_fwd(q, k, v, kv_mask, True, 0.1)
    assert bool((out[1] == 0).all()) and bool((lse[1] == kernels.LSE_MASKED).all())
    delta = torch.zeros(b, h, s, device=card)
    dq = kernels.flash_attention_bwd_dq(q, k, v, kv_mask, g, lse, delta, True, 0.1)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, kv_mask, g, lse, delta, True, 0.1)
    assert all(bool((t[1] == 0).all()) and bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


@pytest.mark.parametrize("tier,s", [("fused", 768), ("flash", 1024)])
def test_flash_attention_autograd_on_the_card(card, tier, s):
    """flash_attention end to end through autograd on the card against
    autograd through mha_reference, at the LLaMA training shape."""
    from stllm_tpu_torch.ops import attention

    q, k, v, kv_mask, g = _attn_inputs(card, 1, s, s, 32, 128, seed=4)
    kv_mask[0, s - 100:] = 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(kernels.LAUNCHES)
    out = attention.flash_attention(*leaves, causal=True, kv_mask=kv_mask, q_mask=kv_mask)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    ran = {n: kernels.LAUNCHES[n] - before[n] for n in before if kernels.LAUNCHES[n] != before[n]}
    assert ran == ({"fused_short_attention": 1} if tier == "fused" else
                   {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                    "flash_attention_bwd_dkv": 1})
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention.mha_reference(*refs, causal=True, kv_mask=kv_mask, q_mask=kv_mask)
    _close_bf16(out, ref)
    for a, w in zip(got, torch.autograd.grad(ref, refs, g)):
        _close_bf16(a, w)


def test_packed_qkv_backward_on_the_card(card):
    from stllm_tpu_torch.ops import attention

    qkv = _qkv(card, 16, 257, 16, 88).requires_grad_()
    g = torch.randn(16, 257, 16 * 88, device=card).bfloat16()
    out = _counted("packed_qkv_attention", lambda: attention.fused_qkv_attention(qkv, 16, 88))
    (got,) = torch.autograd.grad(out, qkv, g)
    ref_in = qkv.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(attention._packed_reference(ref_in, 16, 88, 88 ** -0.5),
                                  ref_in, g)
    _close_bf16(got, want)


# head_dims the tile loops take only zero-padded (20, 36) or not at all (136,
# 176, 256: the "any" form), as the reference takes every head_dim
ANY_HEAD_DIMS = [20, 36, 136, 176, 256]


def _attn_forms_ran(fn):
    """fn() and the training-attention launches it made, by form."""
    before = dict(kernels.FORM_LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {f: kernels.FORM_LAUNCHES[f] - before[f] for f in before
                 if kernels.FORM_LAUNCHES[f] != before[f]}


def _four_kernels_vs_plain(card, b, sq, sk, h, d, dtype, causal, masked, seed):
    """#7, #4, #5 and #6 at (Sq, Sk), each against its plain version (bf16
    3e-2, fp32 1e-5 + 1e-4 relative; lse 1e-3 + 1e-4 relative); returns the
    forms the four launches ran."""
    close = _close_f32 if dtype == torch.float32 else _close_bf16
    q, k, v, kv_mask, g = (t.to(dtype) if t.is_floating_point() else t
                           for t in _attn_inputs(card, b, sq, sk, h, d, seed))
    kv_mask = kv_mask if masked else None
    scale = d ** -0.5
    forms = {}
    got, ran = _attn_forms_ran(lambda: kernels.fused_short_attention(q, k, v, kv_mask, causal,
                                                                     scale))
    forms.update(ran)
    close(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, causal, scale))
    (out, lse), ran = _attn_forms_ran(lambda: kernels.flash_attention_fwd(q, k, v, kv_mask,
                                                                          causal, scale))
    forms.update(ran)
    want_out, want_lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    close(out, want_out)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    delta = (g.float() * want_out.float()).sum(-1).transpose(1, 2).contiguous()
    a = (q, k, v, kv_mask, g, want_lse, delta, causal, scale)
    dq, ran = _attn_forms_ran(lambda: kernels.flash_attention_bwd_dq(*a))
    forms.update(ran)
    (dk, dv), ran = _attn_forms_ran(lambda: kernels.flash_attention_bwd_dkv(*a))
    forms.update(ran)
    for got, want in zip((dq, dk, dv), kernels.flash_attention_bwd_plain(*a)):
        assert got.shape == want.shape and got.dtype == dtype
        close(got, want)
    return forms


ATTN_KERNELS = ("fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")


@pytest.mark.parametrize("causal,masked", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", ANY_HEAD_DIMS)
def test_training_attention_kernels_at_every_head_dim(card, head_dim, dtype, causal, masked):
    """#4-#7 at head_dims the tile loops do not take as they are: 20 and 36
    zero-padded to 24 and 40 on the tile loops, 136, 176 and 256 on the
    "any" form; each launch on that form alone, each result its plain
    version's, in bf16 and fp32."""
    forms = _four_kernels_vs_plain(card, 2, 70, 100, 2, head_dim, dtype, causal, masked, 11)
    form = "tiles" if head_dim <= 128 else "any"
    assert kernels.attn_form(head_dim) == form
    assert forms == {f"{name}/{form}": 1 for name in ATTN_KERNELS}


@pytest.mark.parametrize("head_dim", [64, 88, 128])
def test_training_attention_kernels_keep_the_tile_loops_at_model_head_dims(card, head_dim):
    """Every model's head_dim stays on the tile loops, with no padding."""
    forms = _four_kernels_vs_plain(card, 2, 100, 100, 2, head_dim, torch.bfloat16, True, True,
                                   12)
    assert kernels.attn_padded_width(head_dim) == head_dim
    assert forms == {f"{name}/tiles": 1 for name in ATTN_KERNELS}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_any_form_rows_without_a_visible_key(card, dtype):
    """At head_dim 176: the flash forward gives 0 and lse = 1e30 for a batch
    row with no visible key and the backward 0 there; the fused short
    forward averages v over every key; a key range hidden in every row gets
    dK, dV = 0; Sq != Sk under the causal offsets of both tiers."""
    b, s, h, d = 2, 96, 2, 176
    q, k, v, kv_mask, g = (t.to(dtype) if t.is_floating_point() else t
                           for t in _attn_inputs(card, b, s, s, h, d, seed=13))
    kv_mask[1] = 0
    kv_mask[0, 40:60] = 0
    out, lse = kernels.flash_attention_fwd(q, k, v, kv_mask, True, 0.1)
    assert bool((out[1] == 0).all()) and bool((lse[1] == kernels.LSE_MASKED).all())
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = kernels.flash_attention_bwd_dq(q, k, v, kv_mask, g, lse, delta, True, 0.1)
    dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, kv_mask, g, lse, delta, True, 0.1)
    assert all(bool((t[1] == 0).all()) and bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert not bool(dk[0, 40:60].any()) and not bool(dv[0, 40:60].any())
    close = _close_f32 if dtype == torch.float32 else _close_bf16
    for causal in (False, True):
        got = kernels.fused_short_attention(q, k, v, kv_mask, causal, 0.1)
        close(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, causal, 0.1))
        close(got[1], v[1].float().mean(dim=0, keepdim=True).expand(s, h, d).to(dtype))
    for sq, sk in ((40, 96), (96, 40)):
        a = (q[:, :sq], k[:, :sk], v[:, :sk], kv_mask[:, :sk], True, 0.1)
        close(kernels.fused_short_attention(*a), kernels.fused_short_attention_plain(*a))
        out_q, lse_q = kernels.flash_attention_fwd_plain(*a)
        close(kernels.flash_attention_fwd(*a)[0], out_q)
        dl = (g[:, :sq].float() * out_q.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (*a[:4], g[:, :sq], lse_q, dl, True, 0.1)
        close(kernels.flash_attention_bwd_dq(*bwd), kernels.flash_attention_bwd_plain(*bwd)[0])
        for got, want in zip(kernels.flash_attention_bwd_dkv(*bwd),
                             kernels.flash_attention_bwd_plain(*bwd)[1:]):
            close(got, want)


def test_training_attention_kernels_refuse_what_they_cannot_take(card):
    """Every head_dim is taken (the reference takes it): the refusals left
    are the dtypes, the shapes, the mask and the rows, and an empty tensor."""
    q, k, v, kv_mask, g = _attn_inputs(card, 1, 64, 64, 2, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.fused_short_attention(q.float(), k, v, None, True, 0.1)    # mixed dtypes
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.flash_attention_fwd(q.half(), k.half(), v.half(), None, True, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.fused_short_attention(q.half(), k.half(), v.half(), None, True, 0.1)
    with pytest.raises(ValueError):
        kernels.flash_attention_fwd(q, k[:, :32], v, None, True, 0.1)         # k != v
    with pytest.raises(ValueError, match="empty"):
        kernels.flash_attention_fwd(q[:, :0], k, v, None, True, 0.1)          # no query
    with pytest.raises(ValueError, match="empty"):
        kernels.fused_short_attention(q[..., :0], k[..., :0], v[..., :0], None, True, 0.1)
    for d in (20, 176):     # taken, on the form attn_form picks
        qd = torch.randn(1, 8, 2, d, device=card).bfloat16()
        assert kernels.fused_short_attention(qd, qd, qd, None, True, 0.1).shape == qd.shape
    with pytest.raises(ValueError):
        kernels.fused_short_attention(q, k, v, kv_mask[:, :32], True, 0.1)    # mask shape
    with pytest.raises(ValueError):
        kernels.fused_short_attention(q, k, v, kv_mask.cpu(), True, 0.1)      # mask device
    lse = torch.zeros(1, 2, 64, device=card)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_dq(q, k, v, None, g, lse[:, :1], lse, True, 0.1)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_dkv(q, k, v, None, g, lse, lse.double(), True, 0.1)


# ---------------------------------------------------------------------------
# the int8 GEMMs: #11, the s8 matmul with the residual add, LayerNorm and
# static int8 in its epilogue, and #8, the blockwise dynamic-quant matmul.
# #11: codes at most one step apart (the kernel sums the LayerNorm statistics
# in another order), x_new within atol = rtol = 1e-2 (it rounds the same fp32
# sum). #8: within atol = 1e-2 times the plain output's largest magnitude and
# rtol = 1e-2, as the weight-streaming matmuls (its products and scale steps
# are the plain version's own, one by one).
# ---------------------------------------------------------------------------

def _weight(card, gen, k, n, layout):
    w = torch.randint(-127, 128, (k, n), generator=gen, device=card, dtype=torch.int8)
    return w.t().contiguous().t() if layout == "column" else w


def _res_ln_inputs(card, b, s, k, n, *, per_row, dtype=torch.bfloat16, layout="column",
                   seed=20):
    """int8 codes and scales that give O(1) outputs, as the ViT's proj and
    fc2 sites do."""
    gen = torch.Generator(device=card).manual_seed(seed)
    hq = torch.randint(-127, 128, (b, s, k), generator=gen, device=card, dtype=torch.int8)
    hs = (torch.rand(b, s, 1, generator=gen, device=card) * 0.01 + 1e-3 if per_row
          else torch.tensor(0.004, device=card))
    ws = torch.rand(n, generator=gen, device=card) * 0.002 * (384 / k) ** 0.5
    bias = torch.randn(n, generator=gen, device=card) * 0.02
    x = torch.randn(b, s, n, generator=gen, device=card).to(dtype)
    gamma = torch.randn(n, generator=gen, device=card)
    beta = torch.randn(n, generator=gen, device=card) * 0.1
    return (hq, hs, _weight(card, gen, k, n, layout), ws, bias, x, gamma, beta,
            torch.tensor(0.05, device=card))


# (B, S, K, N, per-row hs, x dtype, weight layout): the ViT-g proj and fc2
# sites, the tiny model's shape in fp32, a row-major (converted) weight, a
# short ragged K, one N for each row width the kernel is built for, then the
# rows wider than 1536 (staged in chunks: 2 x 1024, 3 x 1408, 6 x 1408 at
# most) and K that are not multiples of 16 (padded with zero codes); then
# the cluster form: rows that are not a multiple of its 128-row tile, the
# scalar-hs fc2 site in fp32 x_prev, and N = 1024 and 2048 (slices of 128 and
# 256 columns; 1408 is the sites' 176)
RES_LN_CASES = [(16, 257, 1408, 1408, True, torch.bfloat16, "column"),
                (16, 257, 6144, 1408, False, torch.bfloat16, "column"),
                (2, 17, 384, 256, True, torch.float32, "column"),
                (3, 37, 1408, 1408, True, torch.bfloat16, "row"),
                (1, 5, 80, 128, False, torch.bfloat16, "column"),
                (2, 9, 256, 640, True, torch.float32, "column"),
                (1, 20, 256, 1536, False, torch.bfloat16, "column"),
                (4, 257, 1408, 2048, True, torch.bfloat16, "column"),
                (2, 257, 1408, 3968, False, torch.bfloat16, "column"),
                (2, 16, 1408, 8192, True, torch.bfloat16, "column"),
                (2, 9, 512, 1664, True, torch.float32, "row"),
                (3, 37, 1000, 1408, True, torch.bfloat16, "column"),
                (1, 20, 40, 256, False, torch.bfloat16, "row"),
                (3, 67, 1408, 1408, True, torch.bfloat16, "column"),
                (4, 257, 6144, 1408, False, torch.float32, "column"),
                (2, 100, 512, 1024, True, torch.bfloat16, "column"),
                (1, 300, 1408, 2048, False, torch.float32, "column")]


@pytest.mark.parametrize("case", RES_LN_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-k{c[2]}-n{c[3]}-{c[5]}-{c[6]}")
def test_qmm_res_ln_kernel_matches_plain(card, case):
    b, s, k, n, per_row, dtype, layout = case
    args = _res_ln_inputs(card, b, s, k, n, per_row=per_row, dtype=dtype, layout=layout)
    x_new, yq = _counted("qmm_res_ln", lambda: kernels.qmm_res_ln(*args, 1e-6))
    want_x, want_q = kernels.qmm_res_ln_plain(*args, 1e-6)
    assert x_new.dtype == dtype and yq.dtype == torch.int8 and yq.shape == want_q.shape
    torch.testing.assert_close(x_new.float(), want_x.float(), atol=1e-2, rtol=1e-2)
    assert int((yq.int() - want_q.int()).abs().max()) <= 1


@pytest.mark.parametrize("shape", [(16, 257, 1408, 1408), (16, 257, 6144, 1408),
                                   (1, 5, 256, 1024)])
def test_qmm_res_ln_forms_agree(card, shape):
    """Where the cluster form runs, the 16-row kernel (the design it
    replaced) gives x_new within 1e-2 and codes at most one step apart."""
    b, s, k, n = shape
    args = _res_ln_inputs(card, b, s, k, n, per_row=True)
    x_c, q_c = kernels._qmm_res_ln(*args, 1e-6, "cluster")
    x_r, q_r = kernels._qmm_res_ln(*args, 1e-6, "rows")
    torch.testing.assert_close(x_c.float(), x_r.float(), atol=1e-2, rtol=1e-2)
    assert int((q_c.int() - q_r.int()).abs().max()) <= 1


# the ViT-g fc1 and fc2 shapes, then widths the reference's tile rule takes
# whole that are no multiple of 16 (K: 40, 13, 1000) or 8 (N: 20, 100, 1500,
# and the odd 1535), seventeen k-blocks of 128 (K 2176), and row counts that
# are no multiple of any tile (5, 7, 111, 666)
WS_CASES_8 = [(16, 257, 1408, 6144, torch.bfloat16, "column"),
              (16, 257, 6144, 1408, torch.bfloat16, "column"),
              (2, 64, 256, 384, torch.float32, "column"),
              (1, 8, 4096, 256, torch.float32, "row"),
              (3, 37, 80, 136, torch.bfloat16, "column"),
              (1, 5, 40, 20, torch.bfloat16, "column"),
              (1, 5, 40, 20, torch.float32, "row"),
              (1, 5, 13, 1536, torch.bfloat16, "column"),
              (1, 5, 13, 1536, torch.float32, "column"),
              (1, 5, 1000, 100, torch.bfloat16, "row"),
              (1, 5, 1000, 100, torch.float32, "column"),
              (1, 5, 2048, 1500, torch.bfloat16, "column"),
              (1, 7, 40, 1535, torch.bfloat16, "column"),
              (3, 37, 2176, 384, torch.float32, "column"),
              (2, 333, 2176, 1500, torch.bfloat16, "column")]


def _blockwise_inputs(card, b, s, k, n, dtype, layout, seed=21):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(b, s, k, generator=gen, device=card).to(dtype)
    w = _weight(card, gen, k, n, layout)
    return x, w, torch.rand(n, generator=gen, device=card) * 0.002


@pytest.mark.parametrize("case", WS_CASES_8, ids=lambda c: f"{c[0]}x{c[1]}-k{c[2]}-n{c[3]}-{c[4]}")
def test_quant_matmul_blockwise_kernel_matches_plain(card, case):
    from stllm_tpu_torch.ops.quant import _pick_tile

    b, s, k, n, dtype, layout = case
    x, w, ws = _blockwise_inputs(card, b, s, k, n, dtype, layout)
    bk = _pick_tile(k, 2048)
    got = _counted("quant_matmul_blockwise", lambda: kernels.quant_matmul_blockwise(x, w, ws, bk))
    _assert_ws_close(got, kernels.quant_matmul_blockwise_plain(x, w, ws, bk))


@pytest.mark.parametrize("case", [(16, 257, 1408, torch.bfloat16), (16, 257, 6144, torch.bfloat16),
                                  (3, 37, 2176, torch.float32), (1, 5, 40, torch.bfloat16),
                                  (1, 5, 13, torch.float32), (1, 5, 20, torch.bfloat16),
                                  (2, 9, 1000, torch.float32)],
                         ids=lambda c: f"{c[0]}x{c[1]}-k{c[2]}-{c[3]}")
def test_blockwise_quant_pass_equals_plain(card, case):
    """#8's first launch: every k-block's codes and scale are the plain
    per-row quantization's exactly (register form, the divide through the
    row's reciprocal, at 1408, 2048, 128, 40 and 1000 wide; the element form
    at 13 and 20), and the codes' tail up to Kp is zero."""
    from stllm_tpu_torch.ops.quant import _pick_tile

    b, s, k, dtype = case
    x = torch.randn(b, s, k, generator=torch.Generator(device=card).manual_seed(22),
                    device=card).to(dtype)
    x[0, 0] = 0.0                                   # an all-zero row: scale 1
    bk = _pick_tile(k, 2048)
    codes, scales = kernels._blockwise_quant_pass(x, bk)
    torch.cuda.synchronize()
    kp = -(-k // 16) * 16
    assert codes.shape == (b * s, kp) and scales.shape == (b * s, k // bk)
    assert not bool(codes[:, k:].any())
    xf = x.float().reshape(b * s, k)
    for j in range(k // bk):
        want_q, want_s = kernels.rowwise_quant_plain(xf[:, j * bk:(j + 1) * bk])
        assert torch.equal(codes[:, j * bk:(j + 1) * bk], want_q)
        assert torch.equal(scales[:, j:j + 1], want_s)


def test_quant_matmul_blockwise_makes_two_launches(card):
    """One call at the fc1 and fc2 shapes runs two kernels on the card (the
    quant pass, then the GEMM) and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from stllm_tpu_torch.ops.quant import _pick_tile

    for k, n in ((1408, 6144), (6144, 1408)):
        x, w, ws = _blockwise_inputs(card, 16, 257, k, n, torch.bfloat16, "column")
        kernels.quant_matmul_blockwise(x, w, ws, _pick_tile(k, 2048))   # built and loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernels.quant_matmul_blockwise(x, w, ws, _pick_tile(k, 2048))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 2, names
        assert sum("block_quant_regs" in e for e in names) == 1, names
        assert sum("gemm_kernel" in e for e in names) == 1, names


def test_int8_gemm_kernels_refuse_what_they_cannot_take(card):
    args = list(_res_ln_inputs(card, 1, 4, 64, 128, per_row=True))
    with pytest.raises(TypeError):
        kernels.qmm_res_ln(*args[:5], args[5].half(), *args[6:])            # fp16 x_prev
    with pytest.raises(ValueError):
        kernels.qmm_res_ln(*_res_ln_inputs(card, 1, 4, 64, 200, per_row=True))    # N % 128
    x = torch.randn(2, 4, 64, device=card)
    w = torch.zeros((64, 16), device=card, dtype=torch.int8)
    ws = torch.ones(16, device=card)
    with pytest.raises(TypeError):
        kernels.quant_matmul_blockwise(x.half(), w, ws, 64)                # fp16 x
    with pytest.raises(ValueError):
        kernels.quant_matmul_blockwise(x, w, ws, 48)                       # bk does not divide K


# ---------------------------------------------------------------------------
# the fp32 instantiations of #1, #2 and #4-#7 (csrc/attention_f32.cuh): fp32
# products on the CUDA cores, held to the fp32 plain versions within
# atol = 1e-5 plus rtol = 1e-4 (the sums run in another order); #2's codes at
# most one step apart with scales within the same tolerance.
# ---------------------------------------------------------------------------

F32_ATOL, F32_RTOL = 1e-5, 1e-4


def _close_f32(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("shape", [(2, 257, 4, 88), (8, 16, 4, 88), (2, 37, 3, 24),
                                   (1, 40, 2, 128)])
def test_packed_qkv_kernels_fp32_match_plain(card, shape):
    b, s, h, d = shape
    qkv = _qkv(card, b, s, h, d).float()
    got = _counted("packed_qkv_attention",
                   lambda: kernels.packed_qkv_attention(qkv, h, d, d ** -0.5))
    _close_f32(got, kernels.packed_qkv_attention_plain(qkv, h, d, d ** -0.5))
    (gq, gs) = _counted("packed_qkv_attention_quant",
                        lambda: kernels.packed_qkv_attention_quant(qkv, h, d, d ** -0.5))
    wq, ws = kernels.packed_qkv_attention_quant_plain(qkv, h, d, d ** -0.5)
    assert gq.dtype == torch.int8 and int((gq.int() - wq.int()).abs().max()) <= 1
    torch.testing.assert_close(gs, ws, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("shape", [(2, 100, 100, 2, 32), (2, 70, 130, 3, 64),
                                   (1, 40, 40, 2, 128), (3, 17, 17, 2, 16)])
def test_fused_short_kernel_fp32_matches_plain(card, shape, causal, masked):
    b, sq, sk, h, d = shape
    q, k, v, kv_mask, _ = (t.float() for t in _attn_inputs(card, b, sq, sk, h, d))
    kv_mask = kv_mask.int() if masked else None
    got = _counted("fused_short_attention",
                   lambda: kernels.fused_short_attention(q, k, v, kv_mask, causal, d ** -0.5))
    _close_f32(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, causal, d ** -0.5))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("shape", [(2, 100, 2, 32), (1, 130, 3, 88), (1, 64, 2, 128)])
def test_flash_kernels_fp32_match_plain(card, shape, causal, masked):
    b, s, h, d = shape
    q, k, v, kv_mask, g = (t.float() for t in _attn_inputs(card, b, s, s, h, d, seed=5))
    kv_mask = kv_mask.int() if masked else None
    scale = d ** -0.5
    out, lse = _counted("flash_attention_fwd",
                        lambda: kernels.flash_attention_fwd(q, k, v, kv_mask, causal, scale))
    want_out, want_lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    _close_f32(out, want_out)
    _close_f32(lse, want_lse)
    delta = (g * want_out).sum(-1).transpose(1, 2).contiguous()
    dq = _counted("flash_attention_bwd_dq", lambda: kernels.flash_attention_bwd_dq(
        q, k, v, kv_mask, g, want_lse, delta, causal, scale))
    dk, dv = _counted("flash_attention_bwd_dkv", lambda: kernels.flash_attention_bwd_dkv(
        q, k, v, kv_mask, g, want_lse, delta, causal, scale))
    for got, want in zip((dq, dk, dv), kernels.flash_attention_bwd_plain(
            q, k, v, kv_mask, g, want_lse, delta, causal, scale)):
        _close_f32(got, want)


def test_fp32_forward_rows_without_a_visible_key(card):
    """fp32 as bf16: the flash forward gives 0 and lse = 1e30 for a row with
    no visible key, the fused short forward averages v over every key."""
    b, s, h, d = 2, 96, 2, 64
    q, k, v, kv_mask, _ = (t.float() for t in _attn_inputs(card, b, s, s, h, d, seed=6))
    kv_mask = kv_mask.int()
    kv_mask[1] = 0
    out, lse = kernels.flash_attention_fwd(q, k, v, kv_mask, True, 0.1)
    assert bool((out[1] == 0).all()) and bool((lse[1] == kernels.LSE_MASKED).all())
    got = kernels.fused_short_attention(q, k, v, kv_mask, True, 0.1)
    _close_f32(got, kernels.fused_short_attention_plain(q, k, v, kv_mask, True, 0.1))
