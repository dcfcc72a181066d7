"""Read-level tree resolution on the device.

Semantics (reference krakenutil.cpp:149-200): each distinct hit taxon is a
candidate; its score is the sum of hit counts over its root path; the answer
is the max-score candidate, with ties resolved by the LCA of all tied
candidates; empty hits => 0.

As in krakenuniq_tpu/taxonomy/resolve.py, scores come from Euler-tour
intervals: hit j contributes to candidate i iff tin[t_j] <= tin[t_i] <
tout[t_j], so per k-mer lane
  score_i = #{hits j : tin_j <= tin_i < tout_j}.
`scores` launches the `scores` CUDA kernel (csrc/scores.cu) on CUDA tensors
at every width W; on CPU tensors it runs `_scores_plain`, the direct
all-pairs form. `_scores_sort`, the event-sort form, is a second reference
for the tests.
"""

from __future__ import annotations

import torch

from .. import _kernels

_BIG = 1 << 30  # tin sentinel of non-hit lanes: above every query (< 2^29)
_PLAIN_BLOCK = 1 << 24  # compare-cube elements per chunk of the plain form


def _sentinel_mask(tins, touts, hit_mask):
    """Non-hit j lanes get tin = 2^30, tout = -1 and can never count: the
    input contract of the kernel (and of the TPU kernel it replaces)."""
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


def scores(tins: torch.Tensor, touts: torch.Tensor, hit_mask: torch.Tensor) -> torch.Tensor:
    """Interval-stabbing score per lane, int32 [B, W] (garbage at non-hit
    lanes, which the caller masks). CUDA tensors launch the kernel."""
    if tins.device.type == "cpu":
        return _scores_plain(tins, touts, hit_mask)
    tins, touts = _sentinel_mask(tins, touts, hit_mask)
    tins, touts = tins.contiguous(), touts.contiguous()
    dev = _kernels.check_cuda("scores", tins=tins, touts=touts)
    if tins.dtype != torch.int32 or touts.dtype != torch.int32 or tins.dim() != 2:
        raise TypeError("scores: tins/touts must be int32 [B, W]")
    if tins.shape != touts.shape:
        raise ValueError(f"scores: shapes {tuple(tins.shape)} != {tuple(touts.shape)}")
    b, w = tins.shape
    out = torch.empty((b, w), dtype=torch.int32, device=dev)
    _kernels.launch("scores", dev, tins, touts, out, b, w)
    return out


def resolve_reads(
    taxa_dense: torch.Tensor,  # int32 [B, W] dense/pool ids per k-mer (0 = no hit)
    hit_mask: torch.Tensor,  # bool [B, W]
    tin: torch.Tensor,  # int32 [T]
    tout: torch.Tensor,  # int32 [T]
    parent: torch.Tensor,  # int32 [T] parent id (self for roots)
    root_dense: int,
    max_depth: int,
    plain: bool = False,
) -> torch.Tensor:
    """The call per read, int32 [B] (0 = unclassified). `plain=True` takes
    the plain score form on any device (for holding the kernel against it)."""
    t = torch.where(hit_mask, taxa_dense, torch.zeros_like(taxa_dense)).long()
    io = torch.stack([tin, tout], dim=1)  # [T, 2]
    rows = io[t]  # [B, W, 2]
    tins = rows[..., 0]
    touts = rows[..., 1]
    score = (_scores_plain if plain else scores)(tins, touts, hit_mask)
    score = torch.where(hit_mask, score, torch.zeros_like(score))

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
