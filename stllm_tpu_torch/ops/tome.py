"""Token merging (ToMe-style bipartite soft matching) for the ViT encode
(stllm_tpu/ops/tome.py).

Merging happens at a few stage boundaries (``ViTConfig.merge_schedule``), so
runs of consecutive blocks share one sequence length and the attention
kernels run unchanged between stages. Tokens are split into sets A and B
(alternately, CLS landing in B at slot 0; or, after a temporal fold, B the
first ``nb`` tokens), each A token finds its best cosine match in B, and the
r most similar A tokens are merged into their matches by size-weighted
averaging; nothing merges into CLS. Token sizes carry across stages so later
averages stay weighted. ``fold_frames`` concatenates adjacent frame rows so a
following merge can collapse cross-frame redundancy.

Every merge returns the origin map (the current index of each original
position), so ``unmerge`` gathers back to full resolution (the BTAdapter
branch needs position-aligned features).

This is plain torch on either device: the reference leaves it to XLA. Ties
are broken as the reference's ``lax.top_k`` and ``jnp.argmax`` break them:
the lowest index first (a stable descending sort; ``torch.argmax`` returns
the first maximum).

The selection of a level from a video's own redundancy (``frame_redundancy``,
``select_merge_level``) is host-side numpy, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# Named merge levels for EVA-ViT-g (depth 39, 257 tokens a frame), the
# reference's table:
#   merge_schedule    ((block, tokens_after), ...); block == 39 (== depth) is
#                     the post-trunk spatial re-merge feeding the Q-Former
#                     fewer tokens;
#   temporal_schedule ((block, fold_group, tokens_after), ...) cross-frame folds.
MERGE_LEVELS: Dict[str, Dict[str, tuple]] = {
    "off": {},
    "mild": {"merge_schedule": ((13, 192), (26, 144))},
    "medium": {"merge_schedule": ((13, 160), (26, 96))},
    "aggressive": {"merge_schedule": ((10, 144), (20, 88), (30, 56))},
    "t_mild": {"temporal_schedule": ((8, 2, 320),),
               "merge_schedule": ((39, 128),)},
    "t_medium": {"temporal_schedule": ((8, 2, 288), (20, 2, 320)),
                 "merge_schedule": ((39, 96),)},
    "t_aggressive": {"temporal_schedule": ((6, 2, 288), (16, 2, 288),
                                           (28, 2, 320)),
                     "merge_schedule": ((39, 64),)},
}

# "auto" thresholds on the pooled-frame redundancy statistics (the
# reference's): r_t below each picks the temporal level, r_s the spatial one.
_AUTO_T_AGGRESSIVE = 0.15
_AUTO_T_MEDIUM = 0.45
_AUTO_T_MILD = 0.70
_AUTO_SPATIAL = 1.05


def _host_array(frames) -> np.ndarray:
    if isinstance(frames, torch.Tensor):
        frames = frames.detach().cpu().numpy()
    return np.asarray(frames, np.float32)


def frame_redundancy(frames) -> Tuple[float, float]:
    """(r_t, r_s): mean absolute difference of 8x8-average-pooled frames
    between adjacent frames (temporal) and adjacent pooled columns
    (spatial), each over the pooled frames' std; host-side numpy.

    ``frames``: (T, H, W, C) or (B, T, H, W, C), any real dtype (array or
    tensor). A batch takes the elementwise max over videos: the least
    redundant video governs."""
    f = _host_array(frames)
    if f.ndim == 5:
        if f.shape[0] > 1:
            per = [frame_redundancy(v) for v in f]
            return (max(p[0] for p in per), max(p[1] for p in per))
        f = f[0]
    t = f.shape[0]
    if t > 8:
        # a contiguous window bounds the host cost on long clips
        f = f[t // 2 - 4:t // 2 + 4]
    k = 8
    h2, w2 = f.shape[1] // k * k, f.shape[2] // k * k
    p = f[:, :h2, :w2].reshape(f.shape[0], h2 // k, k, w2 // k, k, -1).mean((2, 4))
    std = float(p.std()) + 1e-6
    r_t = float(np.abs(np.diff(p, axis=0)).mean()) / std if p.shape[0] > 1 else 0.0
    r_s = float(np.abs(np.diff(p, axis=2)).mean()) / std
    return r_t, r_s


def select_merge_level(frames, *, allow_temporal: bool = True) -> str:
    """A MERGE_LEVELS key from the video's own redundancy. Temporal levels
    are demoted to the deepest one whose chained g=2 folds divide the
    clip's frame count; ``allow_temporal=False`` keeps to spatial levels."""
    t = frames.shape[-4] if getattr(frames, "ndim", 0) >= 4 else 1

    def fold_ok(level):
        folds = len(MERGE_LEVELS[level].get("temporal_schedule", ()))
        return t >= 2 ** folds and t % (2 ** folds) == 0

    r_t, r_s = frame_redundancy(frames)
    if allow_temporal and t > 1:
        want = ("t_aggressive" if r_t < _AUTO_T_AGGRESSIVE else
                "t_medium" if r_t < _AUTO_T_MEDIUM else
                "t_mild" if r_t < _AUTO_T_MILD else "")
        if want:
            ladder = ("t_aggressive", "t_medium", "t_mild")
            for level in ladder[ladder.index(want):]:
                if fold_ok(level):
                    return level
    if r_s < _AUTO_SPATIAL:
        return "medium" if r_s < 0.95 else "mild"
    return "off"


def scale_level_to_depth(level: str, depth: int, full_depth: int = 39) -> Dict[str, tuple]:
    """A named full-trunk level on a trunk of ``depth`` blocks: block indices
    scale proportionally (rounded, at least 1), token counts stay, and a
    post-trunk entry (block == full_depth) maps to block == depth."""
    kw = dict(MERGE_LEVELS[level])
    out: Dict[str, tuple] = {}
    if "merge_schedule" in kw:
        out["merge_schedule"] = tuple((max(1, round(b * depth / full_depth)), m)
                                      for b, m in kw["merge_schedule"])
    if "temporal_schedule" in kw:
        out["temporal_schedule"] = tuple((max(1, round(b * depth / full_depth)), g, m)
                                         for b, g, m in kw["temporal_schedule"])
    return out


def level_kwargs(level: str, *, post_trunk: bool = True) -> Dict[str, tuple]:
    """ViTConfig field overrides for a named level ("off" -> {}).
    ``post_trunk=False`` drops the temporal levels' post-trunk re-merge."""
    kw = dict(MERGE_LEVELS[level])
    if not post_trunk and "temporal_schedule" in kw:
        kw.pop("merge_schedule", None)
    return kw


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)`` for (B, N, D) x."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bipartite_merge(x: torch.Tensor, sizes: torch.Tensor, origin: torch.Tensor, m: int, *,
                    nb: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One merge stage: N tokens -> m. ``x`` (B, N, D) with CLS at 0,
    ``sizes`` (B, N) fp32 original tokens per row, ``origin`` (B, N0) the
    current index of each original token. ``nb`` 0 splits A/B alternately;
    ``nb`` > 0 makes B the first nb tokens and A the rest (cross-frame mode
    after ``fold_frames``). Returns (x' (B, m, D) with CLS at 0, sizes',
    origin')."""
    b, n, d = x.shape
    r = n - m
    dev = x.device
    if nb:
        b_pos = torch.arange(nb, device=dev)
        a_pos = torch.arange(nb, n, device=dev)
    else:
        b_pos = torch.arange(0, n, 2, device=dev)   # CLS lands in B at slot 0
        a_pos = torch.arange(1, n, 2, device=dev)
        nb = b_pos.numel()
    na = a_pos.numel()
    if r > na:
        raise ValueError(f"merge {n}->{m} removes {r} > A-set size {na}")
    xa, xb = x[:, a_pos], x[:, b_pos]
    sa, sb = sizes[:, a_pos], sizes[:, b_pos]

    # cosine similarity of every A token to every B token, in fp32
    xf = x.float()
    metric = xf / torch.linalg.vector_norm(xf, dim=-1, keepdim=True).clamp(min=1e-6)
    scores = torch.matmul(metric[:, a_pos], metric[:, b_pos].transpose(1, 2))
    scores[:, :, 0] = -torch.inf                     # never merge into CLS
    best_val = scores.amax(dim=-1)                   # (B, nA)
    best_dst = torch.argmax(scores, dim=-1)          # first maximum, as jnp.argmax

    # the r most similar A tokens merge (ties lowest index first, as
    # lax.top_k); the rest survive in their order
    merge_src = torch.sort(best_val, dim=-1, descending=True, stable=True)[1][:, :r]
    picked = torch.zeros((b, na), dtype=torch.int32, device=dev)
    picked.scatter_(1, merge_src, 1)
    keep_src = torch.sort(picked, dim=1, stable=True)[1][:, :na - r]

    # size-weighted scatter-average of the merged A tokens into their B targets
    sa_m = torch.gather(sa, 1, merge_src)                        # (B, r)
    xa_m = _take(xf[:, a_pos], merge_src)                        # (B, r, D)
    dst = torch.gather(best_dst, 1, merge_src)                   # (B, r)
    add_x = torch.zeros((b, nb, d), dtype=torch.float32, device=dev).scatter_add_(
        1, dst[..., None].expand(-1, -1, d), xa_m * sa_m[..., None])
    add_s = torch.zeros((b, nb), dtype=torch.float32, device=dev).scatter_add_(1, dst, sa_m)
    sb_new = sb + add_s
    xb_new = (xb.float() * sb[..., None] + add_x) / sb_new[..., None]

    x_out = torch.cat([xb_new.to(x.dtype), _take(xa, keep_src)], dim=1)
    s_out = torch.cat([sb_new, torch.gather(sa, 1, keep_src)], dim=1)

    # origin map: B slot j keeps index j, surviving A slot k goes to nb + its
    # rank, a merged A token to its B destination
    a_new = torch.full((b, na), -1, dtype=torch.long, device=dev)
    a_new.scatter_(1, keep_src, (nb + torch.arange(na - r, device=dev)).expand(b, -1))
    a_new.scatter_(1, merge_src, dst)
    new_of_old = torch.zeros((b, n), dtype=torch.long, device=dev)
    new_of_old[:, b_pos] = torch.arange(nb, device=dev)
    new_of_old[:, a_pos] = a_new
    return x_out, s_out, torch.gather(new_of_old, 1, origin.long())


def merge_to(x: torch.Tensor, sizes: torch.Tensor, origin: torch.Tensor, m: int):
    """Merge N -> m tokens in as many alternating-split stages as the
    per-stage cap (at most floor(N/2) removed) requires."""
    while x.shape[1] > m:
        n = x.shape[1]
        x, sizes, origin = bipartite_merge(x, sizes, origin, max(m, n - n // 2))
    return x, sizes, origin


def fold_frames(x: torch.Tensor, sizes: torch.Tensor, origin: torch.Tensor, g: int):
    """Temporal fold: groups of ``g`` adjacent frame rows (R, N, D) become
    one row [cls, frame0 patches, frame1 patches, ...], ``cls`` the
    size-weighted mean of the group's CLS tokens, and every origin entry of
    the old rows is remapped into the folded row. Returns (x' (R/g,
    1 + g(N-1), D), sizes', origin' (R/g, g W))."""
    r, n, d = x.shape
    w = origin.shape[1]
    if r % g:
        raise ValueError(f"{r} rows not divisible by group {g}")
    rg = r // g
    xf = x.float().reshape(rg, g, n, d)
    sz = sizes.reshape(rg, g, n)
    cls_s = sz[:, :, 0]                                           # (rg, g)
    cls_x = (xf[:, :, 0] * cls_s[..., None]).sum(dim=1) / cls_s.sum(dim=1)[..., None]
    patches = xf[:, :, 1:].reshape(rg, g * (n - 1), d)
    x_out = torch.cat([cls_x[:, None].to(x.dtype), patches.to(x.dtype)], dim=1)
    s_out = torch.cat([cls_s.sum(dim=1)[:, None], sz[:, :, 1:].reshape(rg, g * (n - 1))], dim=1)
    # old row j's index o -> 0 (the shared CLS) if o == 0, else o + j(n - 1)
    o = origin.long().reshape(rg, g, w)
    off = (torch.arange(g, device=x.device) * (n - 1)).reshape(1, g, 1)
    o_out = torch.where(o == 0, torch.zeros_like(o), o + off).reshape(rg, g * w)
    return x_out, s_out, o_out


def unmerge(x: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Each original position takes its representative's value:
    (B, m, D), (B, N0) -> (B, N0, D)."""
    return _take(x, origin.long())


def init_merge_state(batch: int, n: int, device=None):
    """(sizes, origin) for an unmerged (batch, n, d) token tensor."""
    sizes = torch.ones((batch, n), dtype=torch.float32, device=device)
    origin = torch.arange(n, device=device).expand(batch, n)
    return sizes, origin
