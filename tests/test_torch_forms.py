"""PyTorch port, on the CPU: the rules that pick the form of the kernels
with more than one form, and the layout in which load_jax_params stores
int8 weights.

- #12 (W4A16 matmul): the one-launch decode form at M <= 16 rows, the
  wgmma mixed-input GEMM above (prefill); the weight-streaming tile loop
  both replaced runs only where a caller asks for it.
- #13-#15 (the decode-budget and unpack probes): #12's decode form on
  their bytes at M <= 16 rows, the tile loop above.
- #11 (s8 matmul + residual + LayerNorm + int8): the cluster form where
  N / 8 is a slice width it is built for (128, 176, 256), else the 16-row
  kernels.
- #1-#3 (the packed-qkv attention kernels): the tile loops at head_dim a
  multiple of 8 up to 128 (every model of the repository), the "any" form
  at every other head_dim.
- #4-#7 (the training attention kernels): the tile loops up to head_dim
  128 (a head_dim that is no multiple of 8 zero-padded to one), the "any"
  form above.
- #9, #10 (LayerNorm -> int8, GELU -> int8): the register form for rows of
  whole 16-byte chunks up to 12288 wide (every model), the "any" form for
  every other width.
- A converted 2-D int8 ``w_q`` leaf is column-major (stride(0) == 1) with the
  same values; a tiny static-int8 ViT converted from JAX gives the same
  outputs bit for bit as the same tree held row-major (the int8 products
  are exact integers in either layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import ctypes

import pytest
import torch

from stllm_tpu.models import vit as jvit
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.ops import kernels


@pytest.mark.parametrize("m,form", [(1, "decode"), (4, "decode"), (16, "decode"),
                                    (17, "wgmma"), (576, "wgmma"), (640, "wgmma")])
def test_w4a16_form_by_rows(m, form):
    assert kernels.w4a16_form(m) == form


def test_w4a16_form_names():
    """#12's forms: the tile loop first (what an entry point without a form
    runs; the probes run on it, #13 and #14 above 16 rows, and the rule no
    longer picks it for #12),
    then the prefill and decode forms, each with a launch counter; an
    unknown form is refused before anything is checked or launched."""
    assert kernels.FORMS["w4a16_matmul"] == ("stream", "wgmma", "decode")
    assert {f"w4a16_matmul/{f}" for f in kernels.FORMS["w4a16_matmul"]} <= set(
        kernels.FORM_LAUNCHES)
    assert {kernels.w4a16_form(m) for m in range(1, 2000)} == {"decode", "wgmma"}
    assert kernels.W4_DECODE_ROWS == 16
    x, packed, scale = torch.zeros(4, 64), torch.zeros(32, 64, dtype=torch.int8), torch.ones(64)
    with pytest.raises(ValueError, match="form"):
        kernels._w4a16_matmul(x, packed, scale, "split-k")


@pytest.mark.parametrize("m,form", [(1, "decode"), (3, "decode"), (16, "decode"),
                                    (17, "stream"), (576, "stream")])
def test_probe_form_by_rows(m, form):
    assert kernels.probe_form(m) == form


@pytest.mark.parametrize("m,form", [(1, "decode"), (4, "decode"), (8, "decode"),
                                    (9, "stream"), (16, "stream"), (17, "stream")])
def test_unpack_form_by_rows(m, form):
    """#15 takes the decode form only where it beat the tile loop on the
    card (one n8 tile of x rows); the decode form itself takes up to 16."""
    assert kernels.unpack_form(m) == form
    assert kernels.UNPACK_DECODE_ROWS == 8 <= kernels.W4_DECODE_ROWS


@pytest.mark.parametrize("name", ["w4v3_matmul", "w8p_matmul", "w4_unpack_matmul"])
def test_probe_form_names(name):
    """#13's, #14's and #15's forms: the tile loop first (what their entry
    point without a form runs), then #12's decode form on their bytes, each
    with a launch counter and (the decode form) a C entry point; the rule
    (``probe_form``, #15's ``unpack_form``) picks both and no other, and an
    unknown form is refused before anything is checked or launched."""
    assert kernels.FORMS[name] == ("stream", "decode")
    assert {f"{name}/{f}" for f in kernels.FORMS[name]} <= set(kernels.FORM_LAUNCHES)
    assert (name, "decode") in kernels._FORM_ENTRY
    rule = kernels.unpack_form if name == "w4_unpack_matmul" else kernels.probe_form
    assert {rule(m) for m in range(1, 2000)} == {"decode", "stream"}
    x, w, scale = torch.zeros(4, 64), torch.zeros(64, 64, dtype=torch.int8), torch.ones(64)
    forced = {"w4v3_matmul": kernels._w4v3_matmul, "w8p_matmul": kernels._w8p_matmul,
              "w4_unpack_matmul": lambda x, w, _, f: kernels._w4_unpack_matmul(x, w, "and8", f)}
    with pytest.raises(ValueError, match="form"):
        forced[name](x, w, scale, "wgmma")


@pytest.mark.parametrize("m,n,dtype,form", [
    (16 * 257, 1408, torch.bfloat16, "cluster"),    # the ViT-g proj and fc2 sites
    (16 * 257, 1408, torch.float32, "cluster"),
    (1, 1408, torch.bfloat16, "cluster"),
    (300, 1024, torch.float32, "cluster"),
    (300, 2048, torch.bfloat16, "cluster"),
    (16 * 257, 1536, torch.bfloat16, "rows"),       # 192-column slices: not built
    (16 * 257, 1280, torch.bfloat16, "rows"),
    (2 * 9, 640, torch.float32, "rows"),
    (20, 256, torch.bfloat16, "rows"),
    (16 * 257, 8192, torch.bfloat16, "rows"),
    (0, 1408, torch.bfloat16, "rows"),
    (16 * 257, 1408, torch.float16, "rows"),
])
def test_qmm_res_ln_form(m, n, dtype, form):
    assert kernels.qmm_res_ln_form(m, n, dtype) == form


@pytest.mark.parametrize("head_dim,form", [(8, "tiles"), (64, "tiles"), (88, "tiles"),
                                           (120, "tiles"), (128, "tiles"), (1, "any"),
                                           (13, "any"), (20, "any"), (36, "any"),
                                           (136, "any"), (200, "any")])
def test_packed_form_by_head_dim(head_dim, form):
    assert kernels.packed_form(head_dim) == form


def test_packed_form_names():
    """#1-#3's forms, the tile loops first (the entry point without a form),
    each with a launch counter; the CPU runs the plain versions and counts
    no launch at either form."""
    names = ("packed_qkv_attention", "packed_qkv_attention_quant", "packed_qkv_attention_s8")
    for name in names:
        assert kernels.FORMS[name] == ("tiles", "any")
        assert {f"{name}/tiles", f"{name}/any"} <= set(kernels.FORM_LAUNCHES)
        assert (name, "any") in kernels._FORM_ENTRY
    before = dict(kernels.FORM_LAUNCHES)
    qkv = torch.randn(1, 5, 3 * 2 * 13)
    kernels.packed_qkv_attention(qkv, 2, 13, 0.3)
    kernels.packed_qkv_attention_quant(qkv, 2, 13, 0.3)
    kernels.packed_qkv_attention_s8(qkv.clamp(-1, 1).mul(127).round().to(torch.int8),
                                    torch.full((3,), 0.01), 2, 13, 0.3)
    assert kernels.FORM_LAUNCHES == before


@pytest.mark.parametrize("head_dim,form,width", [
    (64, "tiles", 64), (88, "tiles", 88), (128, "tiles", 128),     # every model's
    (8, "tiles", 8), (1, "tiles", 8), (13, "tiles", 16), (20, "tiles", 24), (36, "tiles", 40),
    (127, "tiles", 128), (129, "any", 129), (136, "any", 136), (176, "any", 176),
    (256, "any", 256), (1000, "any", 1000)])
def test_attn_form_by_head_dim(head_dim, form, width):
    """#4-#7 take every head_dim, as the reference does: the tile loops up
    to 128, zero-padded to a multiple of 8; the "any" form above, as it is."""
    assert kernels.attn_form(head_dim) == form
    assert kernels.attn_padded_width(head_dim) == width


def test_attn_form_names():
    """#4-#7's forms, the tile loops first (the entry point without a form),
    each with a launch counter and the "any" form's C entry point (the tile
    loop's arguments and io_f32); the CPU runs the plain versions, unpadded,
    and counts no launch at either form."""
    names = ("fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    for name in names:
        assert kernels.FORMS[name] == ("tiles", "any")
        assert {f"{name}/tiles", f"{name}/any"} <= set(kernels.FORM_LAUNCHES)
        symbol, argtypes = kernels._FORM_ENTRY[name, "any"]
        assert symbol == f"stllm_{name}_any"
        assert argtypes[:-1] == kernels._ENTRY[name][1][:-1] + [ctypes.c_int]
    before = dict(kernels.FORM_LAUNCHES)
    for d in (20, 176):
        q = torch.randn(1, 6, 2, d)
        out, lse = kernels.flash_attention_fwd(q, q, q, None, True, 0.1)
        assert out.shape == q.shape and lse.shape == (1, 2, 6)
        assert kernels.fused_short_attention(q, q, q, None, True, 0.1).shape == q.shape
        dq = kernels.flash_attention_bwd_dq(q, q, q, None, q, lse, lse, True, 0.1)
        dk, dv = kernels.flash_attention_bwd_dkv(q, q, q, None, q, lse, lse, True, 0.1)
        assert dq.shape == dk.shape == dv.shape == q.shape
    assert kernels.FORM_LAUNCHES == before


@pytest.mark.parametrize("k,dtype,form", [
    (1408, torch.bfloat16, "registers"),     # the ViT-g LayerNorm and GELU rows
    (6144, torch.bfloat16, "registers"),
    (1408, torch.float32, "registers"),
    (176, torch.float32, "registers"),       # the tiny configs' widths
    (352, torch.bfloat16, "registers"),
    (8, torch.bfloat16, "registers"),
    (12288, torch.bfloat16, "registers"),
    (12288, torch.float32, "registers"),
    (1412, torch.float32, "registers"),      # whole 16-byte chunks of fp32
    (1412, torch.bfloat16, "any"),           # not of bf16
    (13, torch.bfloat16, "any"),
    (13, torch.float32, "any"),
    (4, torch.bfloat16, "any"),
    (12296, torch.bfloat16, "any"),          # wider than the registers hold
    (12296, torch.float32, "any"),
    (16384, torch.bfloat16, "any"),
])
def test_row_quant_form_by_width(k, dtype, form):
    assert kernels.row_quant_form(k, dtype) == form


def test_row_quant_form_names():
    """#9's and #10's forms, the register form first (the entry point
    without a form), each with a launch counter and an entry point; the CPU
    runs the plain versions and counts no launch at either form, and a
    forced form that does not exist is refused on the card only."""
    for name in ("layer_norm_quant", "gelu_quant"):
        assert kernels.FORMS[name] == ("registers", "any")
        assert {f"{name}/registers", f"{name}/any"} <= set(kernels.FORM_LAUNCHES)
        assert (name, "any") in kernels._FORM_ENTRY
    before = dict(kernels.FORM_LAUNCHES)
    x = torch.randn(2, 3, 13)
    kernels.layer_norm_quant(x, torch.ones(13), torch.zeros(13))
    kernels.gelu_quant(x, True)
    assert kernels.FORM_LAUNCHES == before


def test_load_jax_params_stores_int8_w_q_column_major():
    rng = np.random.default_rng(0)
    w_q = rng.integers(-127, 128, (24, 40)).astype(np.int8)
    packed = rng.integers(-128, 128, (12, 40)).astype(np.int8)
    tree = {"fc": {"w_q": w_q, "w_scale": np.ones(40, np.float32)},
            "lin": {"w": rng.standard_normal((24, 40)).astype(np.float32)},
            "w4": {"w4": packed}, "codes": {"w_q": w_q[0]}}
    got = load_jax_params(tree, device="cpu")
    t = got["fc"]["w_q"]
    assert t.dtype == torch.int8 and tuple(t.shape) == (24, 40) and t.stride() == (1, 24)
    np.testing.assert_array_equal(t.numpy(), w_q)
    for leaf in (got["lin"]["w"], got["w4"]["w4"], got["codes"]["w_q"]):
        assert leaf.is_contiguous()
    np.testing.assert_array_equal(got["w4"]["w4"].numpy(), packed)


def _w_q_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from ([(path + (k,), v)] if k == "w_q" else _w_q_leaves(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _w_q_leaves(v, path + (i,))


def _row_major(tree):
    if isinstance(tree, dict):
        return {k: (v.contiguous() if k == "w_q" else _row_major(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_row_major(v) for v in tree)
    return tree


VIT = dict(image_size=28, patch_size=14, width=128, depth=2, heads=4, mlp_hidden=256,
           use_flash=None, gelu_approx=True)


@pytest.mark.parametrize("fused", [False, "both"])
def test_converted_static_vit_same_in_either_layout(fused):
    """A tiny plain ViT quantized and calibrated by JAX, converted: every
    w_q leaf column-major, and the static-int8 forward (unfused, and with
    both fused-LN sites) equal to that of the same tree held row-major."""
    jcfg = jvit.ViTConfig(dtype=jnp.float32, **VIT)
    tcfg = tvit.ViTConfig(dtype=torch.float32, **VIT)
    params = jvit.init_vit(jax.random.PRNGKey(1), jcfg)
    frames = np.random.default_rng(2).integers(0, 256, (2, 28, 28, 3)).astype(np.uint8)
    images = jnp.asarray(frames, jnp.float32) / 255.0
    static = jvit.calibrate_vit_scales(jvit.quantize_vit_params(params), images, jcfg)
    tree = load_jax_params(jax.tree_util.tree_map(np.asarray, static), device="cpu")
    leaves = list(_w_q_leaves(tree))
    assert len(leaves) == 4 * VIT["depth"]          # qkv, proj, fc1, fc2 of each block
    for path, w in leaves:
        assert w.dtype == torch.int8 and w.dim() == 2 and w.stride(0) == 1, path
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 28, 28, 3))
                         .astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvit, "FUSED_LN", fused)
        got = tvit.vit_forward(tree, x, tcfg)
        want = tvit.vit_forward(_row_major(tree), x, tcfg)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=0, rtol=0)
