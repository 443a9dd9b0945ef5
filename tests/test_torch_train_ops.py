"""PyTorch port, the training path's ops (stllm_tpu_torch/ops, data, common,
train/step's optimizer): the same numpy inputs through the JAX function and
its counterpart, in fp32 on the CPU.

The attention kernels' plain versions are held to the JAX Pallas kernels run
in interpret mode (``use_pallas=True, interpret=True`` with 32-row blocks;
``_fused_short_attention(..., interpret=True)`` directly), forward, logsumexp
and gradients. Tolerance 1e-5 (absolute and relative) on unit-scale values:
both sides are fp32 and differ in the order of their sums. Gradients are
taken of sum(out * w) with a fixed unit-normal w, which keeps them at unit
scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stllm_tpu.common import logging as jlog
from stllm_tpu.common import optim as joptim
from stllm_tpu.data import collate as jcollate
from stllm_tpu.data import packing as jpacking
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import zoo as jzoo
from stllm_tpu.ops import attention as jattn
from stllm_tpu.train import step as jstep
from stllm_tpu_torch.common import logging as tlog
from stllm_tpu_torch.common import optim as toptim
from stllm_tpu_torch.common.registry import registry as tregistry
from stllm_tpu_torch.data import collate as tcollate
from stllm_tpu_torch.data import packing as tpacking
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.train import step as tstep


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = RTOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else a for a in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _qkv(seed, b, sq, h, d, sk=None):
    sk = sq if sk is None else sk
    return _rand(seed, b, sq, h, d), _rand(seed + 1, b, sk, h, d), _rand(seed + 2, b, sk, h, d)


def _masks(kind, b, s):
    """(q_mask, kv_mask) as numpy or None: ``pad`` right-pads row 0,
    ``holes`` masks random keys, ``dead`` masks every key of the last batch
    row (and its query rows, as a padded row is)."""
    if kind == "none":
        return None, None
    kv = np.ones((b, s), np.int32)
    if kind == "pad":
        kv[0, s - s // 3:] = 0
        return None, kv
    if kind == "holes":
        kv = np.random.default_rng(5).integers(0, 2, (b, s)).astype(np.int32)
        kv[:, 0] = 1
        return None, kv
    if kind == "qmask":
        kv[0, s - s // 3:] = 0
        return kv.astype(np.float32), kv
    kv[-1] = 0                       # dead
    return kv.astype(np.float32), kv


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, grad=False):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


CASES = [("none", False), ("none", True), ("pad", True), ("holes", False), ("holes", True),
         ("qmask", True), ("dead", False), ("dead", True)]
# head_dims the card's tile loops take only zero-padded (20) or not at all
# (176, the "any" form): two mask cases each
HEAD_DIM_CASES = [("holes", True), ("dead", False)]


def _shape_cases(shapes, wide_shapes):
    """(shape, mask, causal) cases, ids "mask-causal-shapeN": every CASES
    entry at ``shapes``, HEAD_DIM_CASES at ``wide_shapes`` (numbered after
    them)."""
    out = [pytest.param(shape, m, c, id=f"{m}-{c}-shape{i}")
           for m, c in CASES for i, shape in enumerate(shapes)]
    return out + [pytest.param(shape, m, c, id=f"{m}-{c}-shape{i}")
                  for m, c in HEAD_DIM_CASES
                  for i, shape in enumerate(wide_shapes, start=len(shapes))]


# ---------------------------------------------------------------------------
# #7 fused short attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mask,causal", _shape_cases(
    [(2, 40, 2, 16, 40), (1, 24, 3, 8, 56), (2, 56, 2, 24, 24)],
    [(2, 40, 2, 20, 56), (1, 24, 2, 176, 40)]))
def test_fused_short_plain_matches_pallas_kernel(shape, mask, causal):
    b, sq, h, d, sk = shape
    q, k, v = _qkv(0, b, sq, h, d, sk)
    _, kvm = _masks(mask, b, sk)
    scale = d ** -0.5
    want = jattn._fused_short_attention(_j(q), _j(k), _j(v), None, _j(kvm), causal, scale, True)
    got = kernels.fused_short_attention_plain(_t(q), _t(k), _t(v), _t(kvm), causal, scale)
    _close(got, want)


@pytest.mark.parametrize("mask,causal", CASES)
def test_fused_short_tier_forward_and_recompute_backward(mask, causal):
    """flash_attention(use_pallas=None) below 1024 keys: forward the fused
    kernel's plain version, backward the recomputed vjp of mha_reference."""
    b, s, h, d = 2, 48, 2, 16
    q, k, v = _qkv(3, b, s, h, d)
    qm, kvm = _masks(mask, b, s)
    scale = d ** -0.5

    w = _rand(4, b, s, h, d)

    def jloss(q, k, v):
        out = jattn._fused_short_attention(q, k, v, _j(qm), _j(kvm), causal, scale, True)
        return jnp.sum(out * w), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _j(q), _j(k), _j(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, q_mask=_t(qm), kv_mask=_t(kvm))
    assert out.grad_fn.name().startswith("_FusedShortAttention")
    _close(out, want)
    tg = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for got_g, want_g in zip(tg, jg):
        _close(got_g, want_g)


# ---------------------------------------------------------------------------
# #4 flash forward, #5 and #6 backward
# ---------------------------------------------------------------------------

def _jax_flash(causal, qm, kvm):
    return functools.partial(jattn.flash_attention, causal=causal, q_mask=_j(qm),
                             kv_mask=_j(kvm), use_pallas=True, interpret=True,
                             block_q=32, block_k=32)


FLASH_SHAPES = [(2, 64, 2, 32), (1, 80, 2, 24)]
FLASH_WIDE_SHAPES = [(2, 64, 2, 20), (1, 48, 2, 176)]


@pytest.mark.parametrize("shape,mask,causal", _shape_cases(FLASH_SHAPES, FLASH_WIDE_SHAPES))
def test_flash_fwd_plain_matches_pallas_kernel(shape, mask, causal):
    """out and the per-row logsumexp. A row with no visible key gives 0 and
    LSE_MASKED here; the Pallas kernel's lse there depends on its block
    size, so lse is compared on the rows that see a key (every other row is
    zeroed by q_mask in use)."""
    b, s, h, d = shape
    q, k, v = _qkv(6, b, s, h, d)
    qm, kvm = _masks(mask, b, s)
    scale = d ** -0.5
    want_out, want_lse = jattn._flash_core_impl(_j(q), _j(k), _j(v), _j(qm), _j(kvm), causal,
                                                scale, 32, 32, True)
    got_out, got_lse = kernels.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(kvm),
                                                         causal, scale)
    if qm is not None:
        got_out = got_out * _t(qm)[:, :, None, None]
    _close(got_out, want_out)
    want_lse = np.asarray(want_lse)[:, 0, :s].reshape(b, h, s)
    seen = np.ones((b, s), bool) if kvm is None else np.repeat(kvm.any(1)[:, None], s, 1)
    seen = np.repeat(seen[:, None, :], h, 1)
    _close(got_lse.numpy()[seen], want_lse[seen])
    assert bool((got_lse.numpy()[~seen] == kernels.LSE_MASKED).all())
    assert jattn.LSE_MASKED == kernels.LSE_MASKED and jattn.NEG_INF == kernels.NEG_INF


@pytest.mark.parametrize("shape,mask,causal", _shape_cases(FLASH_SHAPES, FLASH_WIDE_SHAPES))
def test_flash_tier_gradients_match_pallas_kernels(shape, mask, causal):
    """flash_attention(use_pallas=True): forward #4's plain version, backward
    the plain dQ and dK/dV formulas from the saved out and lse, against
    jax.grad through the three Pallas kernels."""
    b, s, h, d = shape
    q, k, v = _qkv(9, b, s, h, d)
    qm, kvm = _masks(mask, b, s)
    flash = _jax_flash(causal, qm, kvm)
    w = _rand(10, b, s, h, d)

    def jloss(q, k, v):
        out = flash(q, k, v)
        return jnp.sum(out * w), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _j(q), _j(k), _j(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, q_mask=_t(qm), kv_mask=_t(kvm),
                                use_pallas=True)
    assert out.grad_fn.name().startswith("_FlashAttentionCore")
    _close(out, want)
    tg = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for got_g, want_g in zip(tg, jg):
        _close(got_g, want_g)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_equals_autograd_of_reference(causal):
    """The two wrappers' CPU halves: dq from one, (dk, dv) from the other,
    equal to autograd through mha_reference on the same inputs."""
    b, s, h, d = 2, 40, 2, 16
    q, k, v = (_t(a, True) for a in _qkv(12, b, s, h, d))
    _, kvm = _masks("pad", b, s)
    kvm = _t(kvm)
    scale = 0.3
    g = _t(_rand(15, b, s, h, d))
    ref = tattn.mha_reference(q, k, v, causal=causal, kv_mask=kvm, scale=scale)
    want = torch.autograd.grad(ref, (q, k, v), g)
    with torch.no_grad():
        out, lse = kernels.flash_attention_fwd(q, k, v, kvm, causal, scale)
        delta = (g * out).sum(-1).transpose(1, 2).contiguous()
        dq = kernels.flash_attention_bwd_dq(q, k, v, kvm, g, lse, delta, causal, scale)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, kvm, g, lse, delta, causal, scale)
    for a, w in zip((dq, dk, dv), want):
        _close(a, w)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["fused_short", "flash_fwd", "flash_bwd"])
def test_zero_padded_head_dim_equals_unpadded(kernel, causal):
    """What the card's wrappers do at head_dim 20 (the tile loops take
    multiples of 8): q, k, v and dO zero-padded to attn_padded_width(20) =
    24, the scale of the true head_dim, the outputs sliced back to 20. Zero
    q and k columns add nothing to q.k^T, zero v and dO columns give zero
    output columns, so the plain versions on the padded tensors give the
    unpadded results, lse and dq, dk, dv included."""
    b, sq, sk, h, d = 2, 24, 40, 2, 20
    width = kernels.attn_padded_width(d)
    assert (width, kernels.attn_form(d)) == (24, "tiles")
    q, k, v = (_t(a) for a in _qkv(20, b, sq, h, d, sk))
    _, kvm = _masks("holes", b, sk)
    kvm, g, scale = _t(kvm), _t(_rand(21, b, sq, h, d)), d ** -0.5
    qp, kp, vp, gp = (kernels.pad_head_dim(t, width) for t in (q, k, v, g))
    assert qp.shape[-1] == width and not bool(qp[..., d:].any())
    if kernel == "fused_short":
        want = kernels.fused_short_attention_plain(q, k, v, kvm, causal, scale)
        got = kernels.fused_short_attention_plain(qp, kp, vp, kvm, causal, scale)
        _close(got[..., :d], want)
        return
    want_out, want_lse = kernels.flash_attention_fwd_plain(q, k, v, kvm, causal, scale)
    got_out, got_lse = kernels.flash_attention_fwd_plain(qp, kp, vp, kvm, causal, scale)
    if kernel == "flash_fwd":
        _close(got_out[..., :d], want_out)
        _close(got_lse, want_lse)
        return
    delta = (g * want_out).sum(-1).transpose(1, 2).contiguous()
    want = kernels.flash_attention_bwd_plain(q, k, v, kvm, g, want_lse, delta, causal, scale)
    got = kernels.flash_attention_bwd_plain(qp, kp, vp, kvm, gp, got_lse, delta, causal, scale)
    for a, w in zip(got, want):
        _close(a[..., :d], w)


@pytest.mark.parametrize("sq,sk,use_pallas,want", [
    (64, 64, None, "_FusedShortAttention"), (1023, 1023, None, "_FusedShortAttention"),
    (1024, 1024, None, "_FlashAttentionCore"), (8, 1030, None, "_FlashAttentionCore"),
    (2048, 600, None, "mha"), (64, 64, True, "_FlashAttentionCore"), (64, 64, False, "mha"),
    (1024, 1024, False, "mha")])
def test_flash_attention_tiers(sq, sk, use_pallas, want):
    """Which function runs follows the reference's rule: fused below 1024
    keys with at most 1M scores, flash from 1024 keys on."""
    q = _t(_rand(1, 1, sq, 1, 8), True)
    k, v = _t(_rand(2, 1, sk, 1, 8)), _t(_rand(3, 1, sk, 1, 8))
    out = tattn.flash_attention(q, k, v, use_pallas=use_pallas)
    name = out.grad_fn.name()
    assert name.startswith(want) if want != "mha" else not name.startswith("_F"), name
    _close(out, tattn.mha_reference(q, k, v), atol=1e-5)


def test_kernel_wrappers_refuse_other_devices_and_shapes():
    """On a CPU tensor a wrapper runs its plain version; its CUDA half
    raises on what the kernel does not take rather than falling back."""
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        kernels._attn_args("fused_short_attention", q, q, q, None)      # no kernel for cpu
    with pytest.raises(ValueError):
        kernels._attn_args("fused_short_attention", q, q[:, :2], q, None)   # k != v
    with pytest.raises(ValueError):
        kernels._attn_args("flash_attention_bwd_dq", q, q, q, None, q[:, :2])  # dO != q
    with pytest.raises(ValueError):
        kernels._attn_args("flash_attention_fwd", q[:, :0], q[:, :0], q[:, :0], None)  # empty
    assert set(kernels.SOURCES) == set(kernels._ENTRY) == set(kernels.LAUNCHES)
    for name in ("fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert (kernels.CSRC / kernels.SOURCES[name]).exists()
        assert kernels.CSRC / "flash_attention.cuh" in kernels._source_files(name)


# ---------------------------------------------------------------------------
# #1's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 17, 2, 8), (3, 33, 4, 24)])
def test_packed_qkv_attention_backward(shape):
    """Forward the packed kernel's plain version (clamped exp2 softmax),
    backward the vjp of the plain-softmax packed reference: against jax.grad
    through the Pallas kernel's custom vjp."""
    b, s, h, d = shape
    qkv = _rand(20, b, s, 3 * h * d, scale=0.5)
    w = _rand(21, b, s, h * d)

    def jloss(t):
        out = jattn.fused_qkv_attention(t, h, d, interpret=True)
        return jnp.sum(out * w), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(_j(qkv))
    tq = _t(qkv, True)
    out = tattn.fused_qkv_attention(tq, h, d)
    assert out.grad_fn.name().startswith("_PackedQKVAttention")
    _close(out, want)
    (tg,) = torch.autograd.grad((out * _t(w)).sum(), tq)
    _close(tg, jg)


# ---------------------------------------------------------------------------
# the loss pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labelled", ["some", "none"])
def test_cross_entropy_shifted(labelled):
    logits = _rand(30, 2, 9, 13, scale=2.0)
    labels = np.full((2, 9), -100, np.int32)
    if labelled == "some":
        labels[0, 4:8] = [3, 0, 12, 5]
        labels[1, 6:] = [1, 2, 3]
    want, jg = jax.value_and_grad(jst.cross_entropy_shifted)(_j(logits), _j(labels))
    tl = _t(logits, True)
    got = tst.cross_entropy_shifted(tl, _t(labels))
    _close(got, want)
    _close(torch.autograd.grad(got, tl)[0], jg)


@pytest.mark.parametrize("decode", [True, False])
def test_mvm_project(decode):
    jcfg, tcfg = jst.STLLMConfig(mvm_decode=decode), tst.STLLMConfig(mvm_decode=decode)
    p = {"mvm_decoder": {"head": {"w": _rand(31, 16, 16, scale=0.2), "b": _rand(32, 16)},
                         "norm": {"scale": 1 + _rand(33, 16, scale=0.1), "bias": _rand(34, 16)}}}
    x = _rand(35, 2, 5, 16)
    want = jst._mvm_project(jax.tree_util.tree_map(jnp.asarray, p), _j(x), jcfg)
    got = tst._mvm_project(jax.tree_util.tree_map(torch.from_numpy, p), _t(x), tcfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# schedules, the optimizer, the partition
# ---------------------------------------------------------------------------

STEPS = [0, 1, 2, 3, 7, 10, 11, 50, 99, 100, 150]


@pytest.mark.parametrize("name", ["cosine", "step", "hf", "hf_no_warmup"])
def test_schedules_match_optax(name):
    if name == "cosine":
        j, t = (m.cosine_lr_schedule(1e-3, 1e-5, 10, 100, 1e-6) for m in (joptim, toptim))
    elif name == "step":
        j, t = (m.step_lr_schedule(1e-3, 1e-5, 0.5, 20, 10, 1e-6) for m in (joptim, toptim))
    else:
        ratio = 0.1 if name == "hf" else 0.0
        j, t = (m.linear_warmup_cosine_hf(2e-5, ratio, 100) for m in (joptim, toptim))
    for s in STEPS:
        np.testing.assert_allclose(t(s), float(j(s)), rtol=2e-6, atol=1e-12)


def test_registered_schedulers_match():
    for name, kw in [("linear_warmup_cosine_lr", {}), ("linear_warmup_step_lr",
                                                        {"decay_rate": 0.7})]:
        args = dict(max_epoch=3, iters_per_epoch=20, init_lr=1e-3, min_lr=1e-5,
                    warmup_steps=5, warmup_start_lr=1e-6, **kw)
        from stllm_tpu.common.registry import registry as jregistry
        j = jregistry.get_lr_scheduler_class(name)(**args)
        t = tregistry.get_lr_scheduler_class(name)(**args)
        for s in STEPS:
            np.testing.assert_allclose(t(s), float(j(s)), rtol=2e-6, atol=1e-12)


def _toy_tree(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"llama_proj": {"w": f(6, 5), "b": f(5)},
            "vit": {"btadapter": {"temp": [{"qkv": {"w": f(4, 12)}, "norm1": {"scale": f(4)}}]},
                    "blocks": [{"fc1": {"w": f(4, 8), "b": f(8)}}]},
            "llama": {"layers": [{"q": {"w": f(5, 5)}}, {"q": {"w": f(5, 5)}}], "norm": None}}


@pytest.mark.parametrize("policy", [dict(), dict(freeze_llm=False), dict(freeze_vit=False),
                                    dict(train_btadapter=False)])
def test_partition_matches_reference(policy):
    tree = _toy_tree(0)
    jt, jf = jstep.partition_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jstep.default_trainable(**policy))
    paths = lambda t: {jstep.path_str(p) for p, _ in  # noqa: E731
                       jax.tree_util.tree_flatten_with_path(t)[0]}
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    tt, tf = tstep.partition_params(ttree, tstep.default_trainable(**policy))
    assert set(tt) == paths(jt) and set(tf) == paths(jf)
    assert all(p.requires_grad for p in tt.values())
    assert not any(p.requires_grad for p in tf.values())
    merged = tstep.merge_params(tt, tf)
    flat = dict(tstep.tree_paths(merged))
    assert sorted(flat) == sorted(p for p, _ in tstep.tree_paths(ttree))
    assert isinstance(merged["llama"]["layers"], list) and len(merged["llama"]["layers"]) == 2
    assert all(flat[p] is leaf for p, leaf in tstep.tree_paths(ttree))
    assert tstep.weight_decay_mask(tt) == {
        jstep.path_str(p): bool(m) for p, m in
        jax.tree_util.tree_flatten_with_path(jstep.weight_decay_mask(jt))[0]}


def test_partition_keeps_integer_leaves_frozen():
    tree = {"llama_proj": {"w_q": torch.zeros(3, 3, dtype=torch.int8), "w_scale": torch.ones(3)}}
    tt, tf = tstep.partition_params(tree, lambda path: True)
    assert set(tt) == {"llama_proj/w_scale"} and set(tf) == {"llama_proj/w_q"}


@pytest.mark.parametrize("case", ["clipped", "unclipped", "no_clip", "projector_lr",
                                  "schedule", "no_decay"])
def test_adamw_matches_optax(case):
    """Five steps of the optimizer chain on a toy tree with fixed gradients,
    the first step included (bias correction, eps placement)."""
    tree = {k: v for k, v in _toy_tree(1).items() if k != "llama"}
    kw = dict(learning_rate=1e-2, weight_decay=0.05, max_grad_norm=1.0)
    gscale = 1.0
    if case == "unclipped":
        gscale = 0.01
    elif case == "no_clip":
        kw["max_grad_norm"] = None
    elif case == "projector_lr":
        kw["projector_lr"] = 3e-3
    elif case == "no_decay":
        kw["weight_decay"] = 0.0
    jkw, tkw = dict(kw), dict(kw)
    if case == "schedule":
        jkw["learning_rate"] = joptim.linear_warmup_cosine_hf(1e-2, 0.4, 5)
        tkw["learning_rate"] = toptim.linear_warmup_cosine_hf(1e-2, 0.4, 5)
    jopt, topt = jstep.make_optimizer(**jkw), tstep.make_optimizer(**tkw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    tp = dict(tstep.tree_paths(jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                                      tree)))
    tstate = topt.init(tp)
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: a * gscale, _toy_tree(100 + step))
        g = {k: v for k, v in g.items() if k != "llama"}
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = dict(tstep.tree_paths(jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                                          g)))
        topt.update(tg, tstate, tp)
        want = {jstep.path_str(p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
        for path, p in tp.items():
            np.testing.assert_allclose(p.numpy(), want[path], atol=2e-6, rtol=2e-6,
                                       err_msg=f"{path} step {step}")
    assert tstate["count"] == 5
    norm = tstep.global_norm(list(tg.values()))       # update() scaled tg in place
    if case in ("clipped", "projector_lr", "schedule", "no_decay"):
        np.testing.assert_allclose(float(norm), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the host side: packing, collator, meters
# ---------------------------------------------------------------------------

def _same_batch(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("bos", [None, 1])
def test_packing_is_byte_identical(masked, bos):
    rng = np.random.default_rng(40)
    b, v = 3, 12
    before = [list(rng.integers(3, 90, n)) for n in (2, 5, 3)]
    after = [list(rng.integers(3, 90, n)) for n in (4, 1, 6)]
    answer = [list(rng.integers(3, 90, n)) for n in (7, 30, 2)]     # row 1 overflows
    keep = [m.sample_video_mask(np.random.default_rng(7), b, v) if masked else None
            for m in (jpacking, tpacking)]
    if masked:
        assert keep[0].tobytes() == keep[1].tobytes()
    got = tpacking.pack_training_batch(before, after, answer, v, 32, 0, keep=keep[1], bos_id=bos)
    want = jpacking.pack_training_batch(before, after, answer, v, 32, 0, keep=keep[0], bos_id=bos)
    _same_batch(got, want)
    for n in (1, 127, 128, 129, 1000):
        assert tpacking.bucket_seq_len(n) == jpacking.bucket_seq_len(n)


@pytest.mark.parametrize("text_input,use_mask", [(True, True), (True, False), (False, True)])
def test_collator_is_byte_identical(text_input, use_mask):
    jcfg = jst.STLLMConfig(qformer_text_input=text_input, use_mask=use_mask, video_input="all",
                           max_txt_len=6, end_sym="###")
    tcfg = tst.STLLMConfig(qformer_text_input=text_input, use_mask=use_mask, video_input="all",
                           max_txt_len=6, end_sym="###")
    rng = np.random.default_rng(41)
    samples = [{"image": rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8),
                "instruction_input": f"###Human: <Video><ImageHere></Video> what happens {i} "
                                     "###Assistant:",
                "answer": " ".join(["word"] * (3 + 4 * i))} for i in range(3)]
    jc = jcollate.TrainCollator(jcfg, jzoo.ToyHashTokenizer(200),
                                jzoo.ToyHashTokenizer(100, reserve=2), seed=3)
    tc = tcollate.TrainCollator(tcfg, tzoo.ToyHashTokenizer(200),
                                tzoo.ToyHashTokenizer(100, reserve=2), seed=3)
    for _ in range(2):                   # the second call draws a new mask from the same stream
        got, want = tc(samples), jc(samples)
        _same_batch(got, want)
    assert got["token_ids"].shape[1] % 128 == 0
    assert ("mvm_weight" in got) == use_mask
    assert tcollate.qformer_text_from_instruction(samples[0]["instruction_input"]) == \
        jcollate.qformer_text_from_instruction(samples[0]["instruction_input"])


def test_metric_logger_matches():
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.5]
    meters = []
    for mod in (jlog, tlog):
        ml = mod.MetricLogger()
        ml.add_meter("loss", mod.SmoothedValue(window_size=4, fmt="{value:.4f}"))
        for v in vals:
            ml.update(loss=v, lr=v / 10)
        meters.append(ml)
    j, t = meters
    assert str(t) == str(j) and t.global_avg() == j.global_avg()
    for name in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(t.loss, name) == getattr(j.loss, name)
    with pytest.raises(AttributeError):
        t.missing
    assert list(t.log_every(range(3), 2, "x")) == [0, 1, 2]
