"""Sparse-regime tracking that makes --device-counters BIT-IDENTICAL.

Counterpart of krakenuniq_tpu/classify/sparse_exact.py. The reference HLL
(src/hyperloglogplus.cpp) keeps each per-taxon counter in SPARSE mode (a set
of 32-bit encodings at pPrime=25) until an insert would push the set past
m/4 entries, then converts to dense registers (hyperloglogplus.cpp:496-498).
The classifier builds a FRESH counter per taxon per work unit and merges
unit counters into the global map (classify.cpp:525-543); merge keeps
sparse∪sparse sparse with no size check (hyperloglogplus.cpp:586-665).

So the final global state of a taxon is order-independent given the unit
partition: it ends DENSE iff at least one unit-local counter went dense
(registers = element-wise max over ALL its encodings, which the device
register plane of device_counters.py accumulates), and SPARSE iff every
unit stayed sparse (state = the union of the units' distinct encodings).
Bit-exact device counting therefore needs, beyond the register plane, only
a per-(unit, taxon) went-dense bit and the distinct (taxon, encoding) pairs
of the units that stayed sparse.

A unit-local counter goes dense iff d > m/4, or d == m/4 and the unit's
LAST insert for the taxon is a duplicate (the one-at-a-time semantics of
hll.HLL.insert_encodings): the encoding at the taxon's maximum stream
position occurs more than once in the unit.

`sparse_stats_core` computes that on the device in plain torch: one stable
sort of the lanes by (unit, taxon, encoding) key, whose permutation is the
stream position, segmented scans for per-pair and per-group statistics,
then a second sort that compacts the distinct pairs of stayed-sparse groups
and the went-dense taxon events into one buffer (its used prefix folds
into the SparseTracker). Keys are uint64 bit patterns held in int64; both sorts flip
the sign bit so that they order as unsigned (the pad key is all ones and
the event tag is bit 63: both must sort LAST). It is the plain version of
`sparse_stats`, which on the card builds the keys in one kernel
(`sparse_keys`), keeps the first sort (torch.sort) and does everything
after it in two kernels (csrc/sparse_stats.cu), the second sort included;
`sparse_stats_tiles` is the plain mirror of those kernels' tiled algorithm.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from ..ints import lsr

_PAD_INT = 0xFFFFFFFFFFFFFFFF
_EVENT_TAG_INT = 1 << 63
_PAD = -1  # _PAD_INT as int64 bits
_SIGN = -(1 << 63)  # int64 sign bit; x ^ _SIGN orders uint64 bits as int64
TAXON_BITS = 25  # dense ids must fit (NCBI is ~2.4M nodes; guard in pipeline)
UNIT_BITS = 6  # work units per span (the span grouping caps them at 64)
MAX_UNITS = 1 << UNIT_BITS


def _usort(x: torch.Tensor, stable: bool = False):
    """Sort int64 planes read as uint64: (sorted values, permutation)."""
    s, perm = torch.sort(x ^ _SIGN, stable=stable)
    return s ^ _SIGN, perm


def _seg_cumsum(reset: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive cumsum (vals >= 0): cumsum minus the running value
    at the segment start, recovered with a plain cummax (the global cumsum is
    nondecreasing, so the most recent reset holds the running max of
    `S - vals` over reset lanes). int64 throughout: torch's cumsum of int32
    widens anyway, and the values equal the JAX package's int32 ones."""
    v = vals.to(torch.int64)
    s = torch.cumsum(v, 0)
    start = torch.cummax(torch.where(reset, s - v, torch.full_like(s, -1)), 0).values
    return s - start


def _seg_cummax(reset: torch.Tensor, vals: torch.Tensor, val_bits: int) -> torch.Tensor:
    """Segmented inclusive cummax (vals >= -1, vals + 1 < 2^val_bits): pack
    (segment_id, val) into one monotone-by-segment int64 key and take a plain
    cummax. Segment ids are < 2^29 and val_bits <= 33 here, so the key fits."""
    seg = torch.cumsum(reset.to(torch.int64), 0)
    packed = (seg << val_bits) | (vals.to(torch.int64) + 1)
    m = torch.cummax(packed, 0).values
    return (m & ((1 << val_bits) - 1)) - 1


def _stats_keys(taxa_dense, enc, hll_lanes, unit_id) -> torch.Tensor:
    """The flat sort keys unit<<57 | taxon<<32 | enc of the counted lanes,
    the pad (all ones) elsewhere."""
    b, w = taxa_dense.shape
    if not 0 < b * w < (1 << 29):
        raise ValueError(f"sparse stats over {b * w} lanes: need 0 < B*W < 2^29 (the scan packing)")
    unit = unit_id.to(torch.int64)[:, None]
    key = (
        (unit << (32 + TAXON_BITS))
        | (taxa_dense.to(torch.int64) << 32)
        | (enc.to(torch.int64) & 0xFFFFFFFF)
    )
    return torch.where(hll_lanes, key, torch.full_like(key, _PAD)).reshape(-1)


def sparse_stats_core(
    taxa_dense: torch.Tensor,  # int32 [B, W] (0 = miss, counted like any taxon)
    enc: torch.Tensor,  # int32 [B, W]: uint32 HLL encodings as bit patterns
    hll_lanes: torch.Tensor,  # bool [B, W] counted lanes
    unit_id: torch.Tensor,  # integer [B]: work-unit index per row, < 64
    p: int,
    cap: int,
):
    """Returns (buf int64 [min(cap, B*W)], n_pairs int32, n_events int32),
    buf holding uint64 bit patterns, all on the input's device.

    buf[:n_pairs] holds pair keys unit<<57|taxon<<32|enc (distinct pairs of
    groups that stayed sparse), buf[n_pairs:n_pairs+n_events] holds event
    keys 1<<63|unit<<25|taxon (groups that went dense), the rest pads (all
    ones). If n_pairs + n_events > cap the buffer is truncated and the
    caller must fall back to host stats for the whole span. The plain
    version of `sparse_stats`."""
    th = (1 << p) // 4
    keyf = _stats_keys(taxa_dense, enc, hll_lanes, unit_id)
    n = keyf.numel()
    # a STABLE sort keeps equal keys in stream order, so its permutation is
    # each sorted lane's stream position (jax.lax.sort is stable by default)
    ks, ps = _usort(keyf, stable=True)
    valid = ks != _PAD

    gk = lsr(ks, 32)  # (unit, taxon) group key
    one = torch.ones(1, dtype=torch.bool, device=ks.device)
    pb = torch.cat([one, ks[1:] != ks[:-1]]) & valid  # pair first
    gb = torch.cat([one, gk[1:] != gk[:-1]]) & valid  # group first
    pe = torch.cat([ks[1:] != ks[:-1], one]) & valid  # pair last
    ge = torch.cat([gk[1:] != gk[:-1], one]) & valid  # group last

    pos_bits = max(2, int(n - 1).bit_length() + 2)
    # at a pair-end lane ps is the pair's max stream position and pb says the
    # pair is a singleton; the group max of (maxpos << 1 | singleton) belongs
    # to the pair holding the group's LAST stream position, and its low bit
    # says that last insert was a first occurrence
    v_pair = torch.where(pe, (ps << 1) | pb.to(torch.int64), torch.full_like(ps, -1))
    edge_v = _seg_cummax(gb, v_pair, pos_bits + 1)
    d_sofar = _seg_cumsum(gb, pb)  # distinct pairs so far in the group

    stays_end = (d_sofar < th) | ((d_sofar == th) & ((edge_v & 1) == 1))
    # broadcast the group-end decision to every lane of the group: reversed,
    # each group starts at its end, which carries the decision
    stays_rev = _seg_cummax(torch.flip(ge, (0,)), torch.flip(ge & stays_end, (0,)), 2)
    stays_lane = torch.flip(stays_rev, (0,)) > 0

    emit_pair = pb & stays_lane
    emit_event = ge & ~stays_lane & valid
    taxon_of = gk & ((1 << TAXON_BITS) - 1)
    unit_of = lsr(gk, TAXON_BITS)
    event_key = _SIGN | (unit_of << TAXON_BITS) | taxon_of
    pad = torch.full_like(ks, _PAD)
    out_key = torch.where(emit_pair, ks, torch.where(emit_event, event_key, pad))
    packed = _usort(out_key)[0][:cap]
    return (
        packed,
        emit_pair.sum(dtype=torch.int32),
        emit_event.sum(dtype=torch.int32),
    )


def _agg_op(a: tuple, b: tuple) -> tuple:
    """The kernels' scan operator on (group start seen, pair starts since
    the last group start, largest pair-end value since it, that group
    start's sorted lane or -1)."""
    if b[0]:
        return b
    return (a[0], a[1] + b[1], max(a[2], b[2]), a[3])


def sparse_stats_tiles(taxa_dense, enc, hll_lanes, unit_id, p: int, cap: int, tile: int = 4096):
    """`sparse_stats_core`'s result by the algorithm of the `sparse_stats`
    kernels (csrc/sparse_stats.cu), in plain torch over tiles of `tile`
    sorted lanes: the sign-flipped keys of the key build, the stable sort,
    then (A) each tile scanned from the state carried into it (the tiles
    before it combined back to the nearest one in which a group starts),
    every group's end lane writing its decision at the group's start lane
    and adding to the two totals, each tile keeping the group start carried
    into it; and (B) each lane reading the decision at its group's start
    and each tile writing its pairs and events after those of the tiles
    before it (the events after all pairs)."""
    th = (1 << p) // 4
    sk, ps = torch.sort(_stats_keys(taxa_dense, enc, hll_lanes, unit_id) ^ _SIGN, stable=True)
    k = sk ^ _SIGN
    n = k.numel()
    pad = torch.full((1,), _PAD, dtype=torch.int64, device=k.device)
    kp, kn = torch.cat([pad, k[:-1]]), torch.cat([k[1:], pad])
    g, gp, gn = lsr(k, 32), lsr(kp, 32), lsr(kn, 32)
    valid = k != _PAD
    pb, gb = valid & (k != kp), valid & (g != gp)
    pe, ge = valid & (k != kn), valid & (g != gn)
    v = torch.where(pe, (ps << 1) | pb.to(torch.int64), torch.full_like(ps, -1))
    val_bits = max(2, int(n - 1).bit_length() + 2) + 1
    lane = torch.arange(n, dtype=torch.int64, device=k.device)
    starts = torch.cummax(torch.where(gb, lane, torch.full_like(lane, -1)), 0).values  # each lane's last group start

    stays = torch.zeros(n, dtype=torch.bool, device=k.device)
    aggs, head_start, n_pairs, n_events = [], [], 0, 0
    for t0 in range(0, n, tile):  # (A)
        carry = (0, 0, -1, -1)
        for a in reversed(aggs):  # the walk back to the nearest group start
            carry = _agg_op(a, carry)
            if a[0]:
                break
        head_start.append(carry[3])
        sl = slice(t0, min(n, t0 + tile))
        gbt, pbt, get = gb[sl], pb[sl].to(torch.int64), ge[sl]
        seg = torch.cumsum(gbt.to(torch.int64), 0)
        cs = torch.cumsum(pbt, 0)
        d_loc = cs - torch.cummax(torch.where(gbt, cs - pbt, torch.zeros_like(cs)), 0).values
        e_loc = _seg_cummax(gbt, v[sl], val_bits)
        head = seg == 0  # before the tile's first group start: the carried group
        d_run = torch.where(head, carry[1] + d_loc, d_loc)
        e_run = torch.where(head, torch.clamp(e_loc, min=carry[2]), e_loc)
        s_run = torch.where(head, torch.full_like(lane[sl], carry[3]), starts[sl])
        dec = (d_run < th) | ((d_run == th) & ((e_run & 1) == 1))
        stays[s_run[get]] = dec[get]
        n_pairs += int(d_run[get & dec].sum())
        n_events += int((get & ~dec).sum())
        flag = bool(seg[-1] > 0)
        aggs.append((int(flag), int(d_loc[-1]), int(e_loc[-1]), int(starts[sl][-1]) if flag else -1))

    buf = torch.full((min(cap, n),), _PAD, dtype=torch.int64, device=k.device)
    before = (0, 0)  # pairs and events of the tiles before this one
    for i, carried in enumerate(head_start):  # (B)
        sl = slice(i * tile, min(n, (i + 1) * tile))
        in_tile = torch.where(gb[sl], lane[sl], torch.full_like(lane[sl], -1))
        gs = torch.clamp(torch.cummax(in_tile, 0).values, min=carried)
        s_lane = stays[gs.clamp(min=0)]
        ep, ee = pb[sl] & s_lane, ge[sl] & ~s_lane
        for emit, key, first in ((ep, k[sl], before[0]), (ee, _SIGN | g[sl], n_pairs + before[1])):
            pos = first + torch.cumsum(emit.to(torch.int64), 0) - 1
            keep = emit & (pos < buf.numel())
            buf[pos[keep]] = key[keep]
        before = (before[0] + int(ep.sum()), before[1] + int(ee.sum()))
    dev = k.device
    return buf, torch.tensor(n_pairs, dtype=torch.int32, device=dev), torch.tensor(n_events, dtype=torch.int32,
                                                                                   device=dev)


# bytes of a unit id the key build reads as it is; other types go as int64
_UNIT_BYTES = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}


def _stats_check(taxa_dense, enc, hll_lanes, unit_id) -> torch.device:
    dev = _kernels.check_cuda("sparse_stats", taxa_dense=taxa_dense, enc=enc, hll_lanes=hll_lanes,
                              unit_id=unit_id)
    if taxa_dense.dtype != torch.int32 or enc.dtype != torch.int32 or hll_lanes.dtype != torch.bool:
        raise TypeError("sparse_stats: taxa_dense and enc must be int32, hll_lanes bool")
    if enc.shape != taxa_dense.shape or hll_lanes.shape != taxa_dense.shape or unit_id.shape != taxa_dense.shape[:1]:
        raise ValueError("sparse_stats: need [B, W] taxa_dense, enc, hll_lanes and [B] unit_id")
    b, w = taxa_dense.shape
    if not 0 < b * w < (1 << 29):
        raise ValueError(f"sparse stats over {b * w} lanes: need 0 < B*W < 2^29 (the scan packing)")
    return dev


def sparse_keys(taxa_dense, enc, hll_lanes, unit_id, scratch=None) -> torch.Tensor:
    """The flat sort keys of `sparse_stats`, sign-flipped (int64 [B*W]:
    `_stats_keys` ^ the sign bit, so that their int64 order is their
    unsigned order). CUDA tensors launch the `sparse_keys` kernel (csrc/
    sparse_stats.cu), which also clears the look-back state of `scratch`
    (kuniq_sparse_stats_scratch words, or None) for the `sparse_stats`
    kernels; CPU tensors run the torch ops."""
    if taxa_dense.device.type == "cpu":
        return _stats_keys(taxa_dense, enc, hll_lanes, unit_id) ^ _SIGN
    dev = _stats_check(taxa_dense, enc, hll_lanes, unit_id)
    if unit_id.dtype not in _UNIT_BYTES:
        unit_id = unit_id.to(torch.int64)
    b, w = taxa_dense.shape
    keys = torch.empty(b * w, dtype=torch.int64, device=dev)
    _kernels.launch("sparse_keys", dev, taxa_dense, enc, hll_lanes, unit_id, _UNIT_BYTES[unit_id.dtype], b, w,
                    keys, scratch)
    return keys


def sparse_stats(taxa_dense, enc, hll_lanes, unit_id, p: int, cap: int):
    """`sparse_stats_core`'s result. CUDA tensors launch the key build
    (`sparse_keys`), sort the keys with torch.sort and launch the
    `sparse_stats` kernels on the sorted keys and their permutation (csrc/
    sparse_stats.cu); CPU tensors run `sparse_stats_core`."""
    if taxa_dense.device.type == "cpu":
        return sparse_stats_core(taxa_dense, enc, hll_lanes, unit_id, p, cap)
    dev = _stats_check(taxa_dense, enc, hll_lanes, unit_id)
    if cap <= 0 or not 2 <= p <= 18:
        raise ValueError(f"sparse_stats: need cap > 0 and 2 <= p <= 18 (cap={cap}, p={p})")
    n = taxa_dense.numel()
    words = _kernels.entry("sparse_stats", "kuniq_sparse_stats_scratch", (ctypes.c_longlong,))(n)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    sk, ps = torch.sort(sparse_keys(taxa_dense, enc, hll_lanes, unit_id, scratch), stable=True)
    buf = torch.empty(min(cap, n), dtype=torch.int64, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    _kernels.launch("sparse_stats", dev, sk, ps, n, (1 << p) // 4, buf, buf.numel(), counts[0], counts[1],
                    scratch)
    return buf, counts[0], counts[1]


def sparse_stats_host(
    taxa_dense: np.ndarray,  # int32 [rows, W] or flat per-lane (with lanes mask)
    enc: np.ndarray,  # uint32
    hll_lanes: np.ndarray,
    unit_bounds: list,
    th: int,
):
    """Numpy mirror of the per-unit decision (the overflow/host-stats form).
    Returns (pair_taxa i64, pair_encs u32, dense_taxa i64)."""
    p_taxa, p_encs, d_taxa = [], [], []
    for s, e in zip(unit_bounds[:-1], unit_bounds[1:]):
        lanes = hll_lanes[s:e]
        t = taxa_dense[s:e][lanes].astype(np.int64)
        v = enc[s:e][lanes]
        if len(t) == 0:
            continue
        order = np.argsort(t, kind="stable")  # stream order within taxon
        ts, vs = t[order], v[order]
        bounds = np.flatnonzero(np.diff(ts)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(ts)]])
        for s_, e_ in zip(starts.tolist(), ends.tolist()):
            encs = vs[s_:e_]
            uniq, first_idx = np.unique(encs, return_index=True)
            d, nn = len(uniq), e_ - s_
            if d > th or (d == th and int(first_idx.max()) < nn - 1):
                d_taxa.append(int(ts[s_]))
            else:
                p_taxa.append(np.full(d, ts[s_], np.int64))
                p_encs.append(uniq)
    return (
        np.concatenate(p_taxa) if p_taxa else np.empty(0, np.int64),
        np.concatenate(p_encs) if p_encs else np.empty(0, np.uint32),
        np.asarray(d_taxa, np.int64),
    )


class SparseTracker:
    """Fold of the per-span sparse statistics, kept on the counters' device.

    State: the dense ids that ever went dense, and the union of distinct
    (taxon, encoding) pairs of stayed-sparse groups as one sorted int64
    tensor of keys taxon << 32 | enc (taxon < 2^31: every key is below
    2^63, so its int64 order is its unsigned order). Spans APPEND their
    pair keys and event ids on the device; deduplication is amortized
    (compact when the appended volume doubles the known union), so the fold
    stays O(U log U) overall, and nothing comes to the host until finalize
    reads `dense_ever` and `sparse_set_of`."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._union = torch.empty(0, dtype=torch.int64, device=self.device)
        self._parts: list[torch.Tensor] = []
        self._n_pending = 0
        self._events: list[torch.Tensor] = []
        self._host: np.ndarray | None = None  # the union on the host, for finalize
        self.overflows = 0

    def add(self, pair_taxa: np.ndarray, pair_encs: np.ndarray, dense_taxa) -> None:
        """Fold host arrays (the host-stats form)."""
        keys = (pair_taxa.astype(np.uint64) << np.uint64(32)) | pair_encs.astype(np.uint64)
        self._add(
            torch.from_numpy(keys.view(np.int64)).to(self.device),
            torch.from_numpy(np.array(dense_taxa, np.int64)).to(self.device),
        )

    def _add(self, keys: torch.Tensor, dense_taxa: torch.Tensor) -> None:
        self._host = None
        self._events.append(dense_taxa)
        if keys.numel():
            self._parts.append(keys)
            self._n_pending += keys.numel()
            if self._n_pending > max(1 << 22, 2 * self._union.numel()):
                self._compact()

    def _compact(self) -> None:
        if self._parts:
            self._union = torch.unique(torch.cat([self._union, *self._parts]), sorted=True)
            self._parts = []
            self._n_pending = 0

    @property
    def n_union(self) -> int:
        """Distinct pairs in the union (compacts it)."""
        self._compact()
        return self._union.numel()

    def consume_buffer(self, buf: torch.Tensor, n_pairs: int, n_events: int) -> bool:
        """Fold one `sparse_stats` buffer (int64 uint64 bit patterns, on the
        tracker's device) without a copy to the host; False = truncated
        (the caller must fall back to host stats for the span)."""
        if n_pairs + n_events > buf.shape[0]:
            self.overflows += 1
            return False
        taxon_mask = (1 << TAXON_BITS) - 1
        self._add(buf[:n_pairs] & ((taxon_mask << 32) | 0xFFFFFFFF), buf[n_pairs : n_pairs + n_events] & taxon_mask)
        return True

    @property
    def dense_ever(self) -> set[int]:
        """The dense ids that went dense in any work unit."""
        if not self._events:
            return set()
        self._events = [torch.unique(torch.cat(self._events))]
        return set(self._events[0].tolist())

    def sparse_set_of(self, dense_id: int) -> np.ndarray:
        """Sorted distinct encodings of a (never-dense) taxon."""
        if self._host is None:
            self._compact()
            self._host = self._union.cpu().numpy()
        s = np.searchsorted(self._host, dense_id << 32, side="left")
        e = np.searchsorted(self._host, (dense_id + 1) << 32, side="left")
        return (self._host[s:e] & 0xFFFFFFFF).astype(np.uint32)
