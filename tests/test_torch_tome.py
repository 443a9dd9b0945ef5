"""PyTorch port, token merging (stllm_tpu_torch/ops/tome.py) and the merged
ViT and BTAdapter trunks against the JAX package.

The merge ops take the same numpy inputs in both packages: the origin maps
must be equal exactly, the values within fp32 tolerance (1e-5 absolute,
1e-4 relative). One input set holds exact ties in the best-match scores
(tokens that are positive multiples of a few one-hot directions, so every
cosine is exactly 0 or 1 in any summation order): both packages take the
lowest index first. The level selection is host-side numpy on the reference
tests' smooth, noisy and static clips.

The merged trunks pick tokens from scores, so the attention math must be
the same on both sides: with ``use_flash=False`` both run plain softmax
attention, and with ``use_flash=None`` the JAX ViT's packed attention runs
its Pallas kernel in interpret mode (as tests/test_torch_models_int8.py
does), beside the port's plain version of kernel #1."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.data.synth import noise_video, synth_video
from stllm_tpu.models import btadapter as jbt
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.models import zoo as jzoo
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import tome as jtome
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import btadapter as tbt
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.ops import tome as ttome


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs tiny eager models: one intra-op thread each. A
    full pool per test process oversubscribes the cores when the suite runs
    in parallel processes, and these many small ops then wait on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL, RTOL = 1e-5, 1e-4
VIT = dict(image_size=56, patch_size=14, width=32, depth=4, heads=2, mlp_hidden=64)
FRAMES = 4
SCHEDULES = {
    "merge": dict(merge_schedule=((1, 12), (2, 8), (4, 5))),
    "fold": dict(temporal_schedule=((1, 2, 24), (3, 2, 30))),
    "both": dict(temporal_schedule=((1, 2, 24),), merge_schedule=((2, 16), (4, 10))),
}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _tokens(kind: str, b: int = 2, n: int = 17, d: int = 16) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        return rng.standard_normal((b, n, d)).astype(np.float32)
    # positive multiples of 4 one-hot directions: every cosine is 0 or 1
    dirs = rng.integers(0, 4, (b, n))
    x = np.zeros((b, n, d), np.float32)
    np.put_along_axis(x, dirs[..., None], rng.uniform(0.5, 2.0, (b, n, 1)).astype(np.float32),
                      axis=-1)
    return x


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` for JAX through one jit of a fresh closure (the
    eager op-by-op path compiles every primitive; a fresh closure never
    shares a trace made under another monkeypatch)."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _state(x, pkg):
    b, n = x.shape[:2]
    if pkg == "jax":
        return (jnp.asarray(x),) + jtome.init_merge_state(b, n)
    return (torch.from_numpy(x),) + ttome.init_merge_state(b, n)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("nb", [0, 9])
def test_bipartite_merge_matches_jax(kind, nb):
    """One stage at both splits, then a second stage on the result: x,
    sizes and the composed origin map."""
    x = _tokens(kind)
    want = _jit(jtome.bipartite_merge, *_state(x, "jax"), m=11, nb=nb)
    got = ttome.bipartite_merge(*_state(x, "torch"), 11, nb=nb)
    want = _jit(jtome.bipartite_merge, *want, m=7)
    got = ttome.bipartite_merge(*got, 7)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(ttome.unmerge(got[0], got[2]).shape, (2, 17, 16))


def test_merge_to_fold_unmerge_and_state_match_jax():
    x = _tokens("random", b=4)
    js, ts = _state(x, "jax"), _state(x, "torch")
    np.testing.assert_array_equal(ts[2].numpy(), np.asarray(js[2]))
    _close(ts[1], js[1])
    want = _jit(jtome.fold_frames, *js, g=2)
    got = ttome.fold_frames(*ts, 2)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    want = _jit(lambda *a: jtome.merge_to(*jtome.bipartite_merge(*a, 20, nb=17), 6), *want)
    got = ttome.merge_to(*ttome.bipartite_merge(*got, 20, nb=17), 6)
    assert got[0].shape == (2, 6, 16)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(ttome.unmerge(got[0], got[2]), _jit(jtome.unmerge, want[0], want[2]))
    with pytest.raises(ValueError):
        ttome.fold_frames(*ts[:2], ts[2], 3)
    with pytest.raises(ValueError):
        ttome.bipartite_merge(*ts, 5)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    smooth = synth_video(rng, 16, 224)
    noise = noise_video(rng, 16, 224)
    static = np.repeat(synth_video(rng, 1, 224), 16, axis=1)
    static6 = np.repeat(synth_video(rng, 1, 224), 6, axis=1)
    return {"smooth": smooth, "noise": noise, "static": static, "static6": static6}


def test_level_selection_matches_jax(clips):
    """frame_redundancy, select_merge_level (both restrictions),
    scale_level_to_depth and level_kwargs equal the JAX package's, and the
    tables and thresholds are the same."""
    assert ttome.MERGE_LEVELS == jtome.MERGE_LEVELS
    for name in ("_AUTO_T_AGGRESSIVE", "_AUTO_T_MEDIUM", "_AUTO_T_MILD", "_AUTO_SPATIAL"):
        assert getattr(ttome, name) == getattr(jtome, name)
    levels = {}
    for name, clip in clips.items():
        assert ttome.frame_redundancy(clip) == jtome.frame_redundancy(clip)
        assert ttome.frame_redundancy(torch.from_numpy(clip)) == jtome.frame_redundancy(clip)
        for allow in (True, False):
            levels[name, allow] = ttome.select_merge_level(clip, allow_temporal=allow)
            assert levels[name, allow] == jtome.select_merge_level(clip, allow_temporal=allow)
    assert levels["static", True] == "t_aggressive" and levels["noise", True] == "off"
    assert levels["smooth", True].startswith("t_") and levels["static6", True] == "t_mild"
    for level in ttome.MERGE_LEVELS:
        for depth in (4, 13):
            assert ttome.scale_level_to_depth(level, depth) == \
                jtome.scale_level_to_depth(level, depth)
        for post in (True, False):
            assert ttome.level_kwargs(level, post_trunk=post) == \
                jtome.level_kwargs(level, post_trunk=post)


@pytest.fixture(scope="module")
def vit_params():
    jc = jvit.ViTConfig(dtype=jnp.float32, **VIT)
    # one jitted init (eager init compiles a program per parameter shape)
    jp = jax.jit(lambda key: jbt.init_btadapter(key, jc, depth=2))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    # zero-init leaves (temporal_fc, biases) get values so the branch counts
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + (rng.standard_normal(a.shape) * 0.02
                                               ).astype(a.dtype)), jp)
    images = rng.standard_normal((FRAMES, 56, 56, 3)).astype(np.float32)
    return jp, load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), images


@pytest.fixture
def jax_packed_interpret(monkeypatch):
    monkeypatch.setattr(jvit, "fused_qkv_attention",
                        functools.partial(jattn.fused_qkv_attention, interpret=True))


def _cfgs(use_flash, **sched):
    return (jvit.ViTConfig(dtype=jnp.float32, use_flash=use_flash, **VIT, **sched),
            tvit.ViTConfig(dtype=torch.float32, use_flash=use_flash, **VIT, **sched))


@pytest.mark.parametrize("use_flash,sched", [(False, "merge"), (False, "fold"),
                                             (False, "both"), (None, "both")])
def test_vit_forward_merged_matches_jax(vit_params, request, use_flash, sched):
    """vit_forward with merge_schedule, temporal_schedule and both (folds of
    4 frames, a post-trunk re-merge), with the origin map."""
    if use_flash is None:
        request.getfixturevalue("jax_packed_interpret")
    jp, tp, images = vit_params
    jc, tc = _cfgs(use_flash, **SCHEDULES[sched])
    want, worigin = _jit(jvit.vit_forward, jp, jnp.asarray(images), cfg=jc,
                         return_merge_origin=True, num_frames=FRAMES)
    got, origin = tvit.vit_forward(tp, torch.from_numpy(images), tc, return_merge_origin=True,
                                   num_frames=FRAMES)
    assert got.shape == want.shape
    _close(got, want)
    assert (origin is None) == (worigin is None)
    if origin is not None:
        np.testing.assert_array_equal(origin.numpy(), np.asarray(worigin))
    with pytest.raises(ValueError):
        bad = dataclasses.replace(tc, temporal_schedule=((1, 8, 20),))
        tvit.vit_forward(tp, torch.from_numpy(images), bad, num_frames=FRAMES)
    with pytest.raises(ValueError):
        tvit.vit_forward(tp, torch.from_numpy(images),
                         dataclasses.replace(tc, merge_schedule=((5, 8),)))


@pytest.mark.parametrize("use_flash,sched", [(False, "merge"), (None, "fold")])
def test_btadapter_forward_merged_matches_jax(vit_params, request, use_flash, sched):
    """The merged trunk with the full-resolution branch: each branch tap
    unmerges through the origin map, the output unmerges at the end."""
    if use_flash is None:
        request.getfixturevalue("jax_packed_interpret")
    jp, tp, images = vit_params
    kw = dict(SCHEDULES[sched])
    kw["merge_schedule"] = tuple(e for e in kw.get("merge_schedule", ()) if e[0] < 4)
    jc, tc = _cfgs(use_flash, **kw)
    want = _jit(jbt.btadapter_forward, jp, jnp.asarray(images), cfg=jc, num_frames=FRAMES)
    got = tbt.btadapter_forward(tp, torch.from_numpy(images), tc, num_frames=FRAMES)
    _close(got, want)


def test_btadapter_refuses_post_trunk_merge(vit_params):
    """A post-trunk entry (block == depth) raises on the BTAdapter in both
    packages, and so do the temporal levels, which carry one (39, n)."""
    jp, tp, images = vit_params
    jc, tc = _cfgs(False, merge_schedule=((4, 8),))
    with pytest.raises(AssertionError):
        jbt.btadapter_forward(jp, jnp.asarray(images), jc, num_frames=FRAMES)
    with pytest.raises(ValueError, match="post-trunk"):
        tbt.btadapter_forward(tp, torch.from_numpy(images), tc, num_frames=FRAMES)
    tcfg = tzoo.build_stllm_config({"model_type": "instructblip_vicuna0_btadapter",
                                    "vit": {"merge_level": "t_mild"}})
    assert tcfg.vit.merge_schedule == ((39, 128),)
    with pytest.raises(ValueError, match="post-trunk"):
        tbt.btadapter_forward(tp, torch.from_numpy(images),
                              dataclasses.replace(tc, **ttome.level_kwargs("t_mild")),
                              num_frames=FRAMES)


def test_fused_ln_gate(monkeypatch, vit_params):
    """Under STLLM_FUSED_LN a merge or fold schedule turns the fused-LN
    static trunk off (the reference's gate): the pipeline runs for the
    unmerged calibrated trunk and not for a merged one, whose output equals
    the per-block loop's."""
    from stllm_tpu_torch.models.vit import calibrate_vit_scales, quantize_vit_params

    _, tp, images = vit_params
    tc = tvit.ViTConfig(dtype=torch.float32, use_flash=None, **VIT)
    plain = {k: v for k, v in tp.items() if k != "btadapter"}
    static = calibrate_vit_scales(quantize_vit_params(plain), torch.from_numpy(images), tc)
    calls = []
    real = tvit._vit_blocks_fused_static
    monkeypatch.setattr(tvit, "_vit_blocks_fused_static",
                        lambda *a: calls.append(1) or real(*a))
    merged = dataclasses.replace(tc, **SCHEDULES["merge"])
    x = torch.from_numpy(images)
    monkeypatch.setattr(tvit, "FUSED_LN", False)
    want = tvit.vit_forward(static, x, merged, num_frames=FRAMES)
    monkeypatch.setattr(tvit, "FUSED_LN", "both")
    tvit.vit_forward(static, x, tc)
    assert calls == [1]
    got = tvit.vit_forward(static, x, merged, num_frames=FRAMES)
    assert calls == [1]
    assert torch.equal(got, want)


def test_resolve_auto_merge_on_a_btadapter_model_drops_the_post_trunk_merge(clips):
    """On a BTAdapter model "auto" resolves as JAX resolves it but for a
    temporal level's post-trunk re-merge (block == depth), which the
    BTAdapter refuses (JAX's btadapter_forward raises on it): the port drops
    it, as level_kwargs(post_trunk=False) does; every other entry equals
    JAX's."""
    seen = set()
    for depth in (39, 4):
        geom = dict(width=32, depth=depth, heads=2, mlp_hidden=64)
        jc = jst.STLLMConfig(vit=jvit.ViTConfig(merge_level="auto", **geom),
                             vit_model="eva_btadapter_g")
        tc = tst.STLLMConfig(vit=tvit.ViTConfig(merge_level="auto", **geom),
                             vit_model="eva_btadapter_g")
        for clip in clips.values():
            jr, tr = jst.resolve_auto_merge(jc, clip), tst.resolve_auto_merge(tc, clip)
            assert tr.vit.temporal_schedule == jr.vit.temporal_schedule
            assert tr.vit.merge_level == jr.vit.merge_level == ""
            assert tr.vit.merge_schedule == tuple(e for e in jr.vit.merge_schedule
                                                  if e[0] < depth)
            assert all(b < depth for b, _ in tr.vit.merge_schedule)
            seen.add(len(jr.vit.merge_schedule) != len(tr.vit.merge_schedule))
    assert seen == {True, False}     # a clip whose level re-merges after the trunk, and not


def test_zoo_and_resolve_auto_merge_match_jax(clips):
    """A named level expands through level_kwargs in build_stllm_config;
    "auto" resolves per video at the 257-token geometry (a full-depth and a
    4-block trunk) and leaves a debug geometry unmerged, as in JAX."""
    for level in ("mild", "t_medium", "auto"):
        jc = jzoo.build_stllm_config({"vit": {"merge_level": level}})
        tc = tzoo.build_stllm_config({"vit": {"merge_level": level}})
        for f in ("merge_schedule", "temporal_schedule", "merge_level"):
            assert getattr(tc.vit, f) == getattr(jc.vit, f)
    geoms = [dict(width=32, heads=2, mlp_hidden=64), dict(width=32, depth=4, heads=2,
                                                          mlp_hidden=64),
             dict(VIT)]
    for geom in geoms:
        jc = jst.STLLMConfig(vit=jvit.ViTConfig(merge_level="auto", **geom))
        tc = tst.STLLMConfig(vit=tvit.ViTConfig(merge_level="auto", **geom))
        for clip in clips.values():
            clip = clip[:, :, :geom.get("image_size", 224), :geom.get("image_size", 224)]
            jr, tr = jst.resolve_auto_merge(jc, clip), tst.resolve_auto_merge(tc, clip)
            for f in ("merge_schedule", "temporal_schedule", "merge_level"):
                assert getattr(tr.vit, f) == getattr(jr.vit, f)
            if geom is geoms[-1]:
                assert tr.vit.merge_schedule == () and tr.vit.temporal_schedule == ()
        assert tst.resolve_auto_merge(tr, clip) is tr
