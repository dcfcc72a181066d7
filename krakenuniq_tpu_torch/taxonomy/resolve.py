"""Read-level tree resolution on the device.

Semantics (reference krakenutil.cpp:149-200): each distinct hit taxon is a
candidate; its score is the sum of hit counts over its root path; the answer
is the max-score candidate, with ties resolved by the LCA of all tied
candidates; empty hits => 0.

As in krakenuniq_tpu/taxonomy/resolve.py, scores come from Euler-tour
intervals: hit j contributes to candidate i iff tin[t_j] <= tin[t_i] <
tout[t_j], so per k-mer lane
  score_i = #{hits j : tin_j <= tin_i < tout_j}   (0 at non-hit lanes).
`scores` launches the `scores` CUDA kernel (csrc/scores.cu) on CUDA tensors
at every width W; on CPU tensors it runs `_scores_plain`, the direct
all-pairs form. `_scores_count` mirrors the kernel's counting form (sorted
tins and touts per row, two searches per query) and `_scores_sort`, the
event-sort form, is a second reference for the tests.
"""

from __future__ import annotations

import torch

from .. import _kernels

_BIG = 1 << 30  # tin sentinel of non-hit lanes: above every query (< 2^29)
_PLAIN_BLOCK = 1 << 24  # compare-cube elements per chunk of the plain form


def _sentinel_mask(tins, touts, hit_mask):
    """Non-hit lanes get tin = 2^30, tout = -1: as j lanes they never
    count, as queries they score 0 (the TPU kernel's input contract)."""
    return (
        torch.where(hit_mask, tins, torch.full_like(tins, _BIG)),
        torch.where(hit_mask, touts, torch.full_like(touts, -1)),
    )


def _scores_plain(tins, touts, hit_mask):
    """All-pairs interval-stabbing scores, chunked over rows and j so the
    [rows, W, j] compare cube stays within _PLAIN_BLOCK elements."""
    tins, touts = _sentinel_mask(tins, touts, hit_mask)
    b, w = tins.shape
    out = torch.zeros((b, w), dtype=torch.int32, device=tins.device)
    tj = min(w, 512)
    rows = max(1, _PLAIN_BLOCK // (w * tj))
    for r0 in range(0, b, rows):
        q = tins[r0 : r0 + rows, :, None]  # [r, W, 1]
        for j0 in range(0, w, tj):
            t = tins[r0 : r0 + rows, None, j0 : j0 + tj]  # [r, 1, tj]
            o = touts[r0 : r0 + rows, None, j0 : j0 + tj]
            out[r0 : r0 + rows] += ((t <= q) & (o > q)).sum(dim=2, dtype=torch.int32)
    return out


def _scores_sort(tins, touts, hit_mask):
    """Event-sort interval-stabbing scores (krakenuniq_tpu's non-TPU form).
    Event keys pack value<<2 | type so starts (0) and ends (1) sort before
    the queries (2) that share their value; Euler times < 2^28 keep the
    packed keys below the 2^30 non-hit sentinel."""
    b, w = tins.shape
    big = torch.full_like(tins, _BIG)
    k_start = torch.where(hit_mask, tins << 2, big)
    k_end = torch.where(hit_mask, (touts << 2) | 1, big)
    k_query = (tins << 2) | 2
    keys = torch.cat([k_start, k_end, k_query], dim=1)  # [B, 3W]
    lane = torch.arange(w, dtype=torch.int32, device=tins.device).expand(b, w)
    payload = torch.cat(
        [torch.full((b, 2 * w), w, dtype=torch.int32, device=tins.device), lane], dim=1
    )
    ks, order = torch.sort(keys, dim=1, stable=True)
    ps = torch.gather(payload, 1, order)
    typ = ks & 3
    weight = (typ == 0).to(torch.int32) - (typ == 1).to(torch.int32)
    running = torch.cumsum(weight, dim=1, dtype=torch.int32)  # #starts<=q - #ends<=q
    back_key = torch.where(typ == 2, ps, torch.full_like(ps, 3 * w))
    _, back = torch.sort(back_key, dim=1, stable=True)
    return torch.gather(running, 1, back)[:, :w]


def _scores_count(tins, touts, hit_mask):
    """The kernel's counting form in plain torch: per row, the hit lanes'
    tins and touts sorted (non-hit lanes pushed past every query), then
    score_i = #{tin_j <= q} - #{tout_j <= q} for q = tin_i, 0 at non-hit
    lanes. Needs tin_j <= tout_j at every hit lane (Euler intervals)."""
    pad = torch.full_like(tins, 2**31 - 1)
    st = torch.sort(torch.where(hit_mask, tins, pad), dim=1).values
    so = torch.sort(torch.where(hit_mask, touts, pad), dim=1).values
    q = tins.contiguous()
    n = torch.searchsorted(st, q, right=True) - torch.searchsorted(so, q, right=True)
    return torch.where(hit_mask, n.to(torch.int32), torch.zeros_like(q))


def scores(tins: torch.Tensor, touts: torch.Tensor, hit_mask: torch.Tensor) -> torch.Tensor:
    """Interval-stabbing score per lane, int32 [B, W], 0 at non-hit lanes.
    CUDA tensors launch the kernel, which reads tins/touts at their strides
    (equal for both, e.g. the two halves of a [B, W, 2] gather) and the
    mask as a contiguous bool [B, W]."""
    if tins.device.type == "cpu":
        return _scores_plain(tins, touts, hit_mask)
    dev = _kernels.check_cuda("scores", hit_mask=hit_mask)
    if tins.device != dev or touts.device != dev:
        raise ValueError("scores: tins, touts and hit_mask must be on one device")
    if tins.dtype != torch.int32 or touts.dtype != torch.int32 or tins.dim() != 2:
        raise TypeError("scores: tins/touts must be int32 [B, W]")
    if hit_mask.dtype != torch.bool:
        raise TypeError("scores: hit_mask must be bool")
    if tins.shape != touts.shape or tins.shape != hit_mask.shape:
        raise ValueError(
            f"scores: shapes {tuple(tins.shape)}, {tuple(touts.shape)}, {tuple(hit_mask.shape)} differ"
        )
    if tins.stride() != touts.stride():
        raise ValueError(f"scores: tins and touts strides {tins.stride()} != {touts.stride()}")
    b, w = tins.shape
    rs, ls = tins.stride()
    out = torch.empty((b, w), dtype=torch.int32, device=dev)
    _kernels.launch("scores", dev, tins, touts, hit_mask, out, b, w, rs, ls)
    return out


def resolve_reads(
    taxa_dense: torch.Tensor,  # int32 [B, W] dense/pool ids per k-mer (0 = no hit)
    hit_mask: torch.Tensor,  # bool [B, W]
    io: torch.Tensor,  # int32 [T, 2]: (tin, tout) per id, built once per table
    parent: torch.Tensor,  # int32 [T] parent id (self for roots)
    root_dense: int,
    max_depth: int,
    plain: bool = False,
) -> torch.Tensor:
    """The call per read, int32 [B] (0 = unclassified). `plain=True` takes
    the plain score form on any device (for holding the kernel against it)."""
    t = torch.where(hit_mask, taxa_dense, torch.zeros_like(taxa_dense)).long()
    rows = io[t]  # [B, W, 2]
    tins = rows[..., 0]
    touts = rows[..., 1]
    score = (_scores_plain if plain else scores)(tins, touts, hit_mask)  # 0 at non-hit lanes

    max_score = score.max(dim=1).values  # [B]
    classified = max_score > 0
    tied = (score == max_score[:, None]) & hit_mask

    # interval hull of the tied set
    tmin = torch.where(tied, tins, torch.full_like(tins, 2**31 - 1)).min(dim=1).values
    tmax = torch.where(tied, tins, torch.full_like(tins, -1)).max(dim=1).values

    # walk up from the FIRST argmax candidate; the first node whose interval
    # contains [tmin, tmax] is the LCA of the tied set. Most reads contain
    # their own hull at once, so the loop exits early.
    start = torch.gather(t, 1, score.argmax(dim=1, keepdim=True))[:, 0]
    node = start
    best = torch.full_like(start, root_dense)
    found = torch.zeros_like(classified)
    parent_l = parent.long()
    for _ in range(max_depth + 1):
        nrows = io[node]  # [B, 2]
        ok = (nrows[:, 0] <= tmin) & (tmax < nrows[:, 1])
        best = torch.where(ok & ~found, node, best)
        found = found | ok
        if bool(found.all()):
            break
        node = parent_l[node]
    # disconnected tied sets fall back to the root (krakenutil.cpp:117)
    call = torch.where(found, best, torch.full_like(best, root_dense))
    return torch.where(classified, call, torch.zeros_like(call)).to(torch.int32)
