"""Device-resident per-taxon accumulation (--device-counters).

Counterpart of krakenuniq_tpu/classify/device_counters.py. The whole
taxon_counts state stays on the device across the run: per-taxon read and
k-mer counters plus dense HLL registers, updated in place every work unit;
the host fetches the state ONCE, at `finalize`. Two CUDA kernels do the
updates:

  * `taxon_counts` (csrc/taxon_counts.cu) adds per-id counts into int64
    accumulators: the read calls and the counted k-mers of a work unit in
    one launch (`taxon_counts_pair`);
  * `hll_regmax` (csrc/hll_regmax.cu) takes the byte max of each counted
    k-mer's rank into its register, for all three register layouts of the
    JAX package (rows = ids, or a lut from id to row).

Register pooling: HLL registers only ever accumulate for taxa that occur as
DATABASE VALUES (counted k-mers carry the database's LCA taxon,
classify.cpp:939), so the register plane is [pool_size, m] over the sorted
distinct dense values (plus 0 for misses), not [taxonomy_size, m]. In
value-pool mode the id space IS the register row space.

Bit-exactness: dense registers alone reproduce the reference only for taxa
whose counters END dense; the sparse-regime tracking of sparse_exact.py
closes the gap (see its module doc). `sparse_cap=0` opts out
(estimate-level compat only).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..hll import HLL, ExactCounter, ReadCounts
from ..ints import clz64
from .sparse_exact import SparseTracker, sparse_stats, sparse_stats_core, sparse_stats_host


def taxon_counts_plain(acc: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of `taxon_counts`."""
    acc += torch.bincount(ids.reshape(-1)[mask.reshape(-1)], minlength=acc.shape[0])
    return acc


COUNTS_THREADS = 512  # threads per block of csrc/taxon_counts.cu
SMEM_BINS = 232_448 // 4  # int32 bins in the shared memory one block may opt into on sm_90


def counts_plan(n_a: int, n_b: int, t: int, sms: int) -> tuple[bool, int, int]:
    """(shared, blocks_a, blocks_b) of one `taxon_counts` launch over two
    segments of n_a and n_b lanes into T = t bins on a card of `sms` SMs.
    The shared-memory form takes T up to SMEM_BINS. A segment gets a block
    per 4 lanes per thread, at most one wave (4 blocks per SM); in the
    shared form also at most one block per ~8 T lanes, which bounds the
    flush to 1/8 of an atomic per lane, but at least one block per SM. An
    empty segment gets no block."""
    shared = t <= SMEM_BINS

    def blocks(n: int) -> int:
        if n == 0:
            return 0
        g = min(-(-n // (4 * COUNTS_THREADS)), 4 * sms)
        return min(g, max(n // (8 * t), sms)) if shared else g

    return shared, blocks(n_a), blocks(n_b)


def _counts_launch(*segments) -> None:
    """One `taxon_counts` launch over one or two (acc, ids, mask) segments
    on the card; the accumulators are of one length T."""
    named = {f"{k}{i}": v for i, seg in enumerate(segments) for k, v in zip(("acc", "ids", "mask"), seg)}
    dev = _kernels.check_cuda("taxon_counts", **named)
    t = segments[0][0].shape[0]
    for acc, ids, mask in segments:
        if acc.dtype != torch.int64 or acc.dim() != 1:
            raise TypeError("taxon_counts: acc must be int64 [T]")
        if ids.dtype != torch.int32 or mask.dtype != torch.bool:
            raise TypeError("taxon_counts: ids must be int32 and mask bool")
        if ids.shape != mask.shape:
            raise ValueError(f"taxon_counts: shapes {tuple(ids.shape)} != {tuple(mask.shape)}")
        if acc.shape[0] != t:
            raise ValueError(f"taxon_counts: accumulators of {t} and {acc.shape[0]} ids")
    if not 0 < t < (1 << 31):
        raise ValueError(f"taxon_counts: T = {t} out of range")
    (acc_a, ids_a, mask_a), *rest = segments
    acc_b, ids_b, mask_b = rest[0] if rest else (None, None, None)
    n_a, n_b = ids_a.numel(), 0 if ids_b is None else ids_b.numel()
    shared, blocks_a, blocks_b = counts_plan(n_a, n_b, t, _kernels.sm_count(dev))
    if blocks_a + blocks_b == 0:
        return
    _kernels.launch(
        "taxon_counts", dev, ids_a, mask_a, acc_a, n_a, ids_b, mask_b, acc_b, n_b, t,
        int(shared), blocks_a, blocks_b,
    )


def taxon_counts(acc: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """acc[t] += #{i : mask[i] and ids[i] == t}, in place; returns acc.
    `acc` int64 [T]; `ids` int32 in [0, T) and `mask` bool, of one shape.
    CUDA tensors launch the `taxon_counts` kernel."""
    if acc.device.type == "cpu":
        return taxon_counts_plain(acc, ids, mask)
    _counts_launch((acc, ids, mask))
    return acc


def taxon_counts_pair(acc_a, ids_a, mask_a, acc_b, ids_b, mask_b):
    """`taxon_counts` on (acc_a, ids_a, mask_a) and on (acc_b, ids_b,
    mask_b), both accumulators of one length T, in one kernel launch on
    the card: a work unit's read counts and k-mer counts. Returns (acc_a,
    acc_b)."""
    if acc_a.device.type == "cpu":
        return taxon_counts_plain(acc_a, ids_a, mask_a), taxon_counts_plain(acc_b, ids_b, mask_b)
    _counts_launch((acc_a, ids_a, mask_a), (acc_b, ids_b, mask_b))
    return acc_a, acc_b


def hll_ranks(enc: torch.Tensor, p: int):
    """(register index, rank) of int32 HLL encoding bit patterns, both int64:
    the dense-insert decode of utils/bits.decode_rank."""
    e = enc.to(torch.int64) & 0xFFFFFFFF
    idx = e >> (32 - p)
    flag_rank = (((e >> 1) & 0x3F) + (25 - p)) & 0xFF
    shifted = (e << p) & 0xFFFFFFFF
    clz = torch.clamp(clz64(shifted) - 32, max=32 - p)  # clz32, 32 for zero
    rank = torch.where((e & 1) == 1, flag_rank, clz + 1)
    return idx, rank


def hll_regmax_plain(reg, taxa, enc, lanes, lut, p: int) -> torch.Tensor:
    """Plain version of `hll_regmax`: a scatter-max on the flat u8 plane."""
    m = reg.shape[1]
    sel = lanes.reshape(-1)
    rows = taxa.reshape(-1)[sel].to(torch.int64)
    if lut is not None:
        rows = lut[rows].to(torch.int64)
    idx, rank = hll_ranks(enc.reshape(-1)[sel], p)
    reg.view(-1).scatter_reduce_(0, rows * m + idx, rank.to(torch.uint8), reduce="amax")
    return reg


def hll_regmax(reg, taxa, enc, lanes, lut, p: int) -> torch.Tensor:
    """reg[row, idx] = max(reg[row, idx], rank) for every counted lane, in
    place; returns reg. `reg` uint8 [P, 2^p]; `taxa` int32 ids, `enc` int32
    HLL encoding bit patterns and `lanes` bool, of one shape; `lut` int32 [T]
    maps an id to its register row, None when rows are ids. CUDA tensors
    launch the `hll_regmax` kernel."""
    if reg.device.type == "cpu":
        return hll_regmax_plain(reg, taxa, enc, lanes, lut, p)
    extra = {} if lut is None else {"lut": lut}
    dev = _kernels.check_cuda("hll_regmax", reg=reg, taxa=taxa, enc=enc, lanes=lanes, **extra)
    if reg.dtype != torch.uint8 or reg.dim() != 2 or not 4 <= p <= 18 or reg.shape[1] != 1 << p:
        raise ValueError("hll_regmax: reg must be uint8 [P, 2^p] with 4 <= p <= 18")
    if taxa.dtype != torch.int32 or enc.dtype != torch.int32 or lanes.dtype != torch.bool:
        raise TypeError("hll_regmax: taxa and enc must be int32, lanes bool")
    if not taxa.shape == enc.shape == lanes.shape:
        raise ValueError("hll_regmax: taxa, enc and lanes must have one shape")
    if lut is not None and (lut.dtype != torch.int32 or lut.dim() != 1):
        raise TypeError("hll_regmax: lut must be int32 [T]")
    n_ids = 0 if lut is None else lut.shape[0]
    _kernels.launch(
        "hll_regmax", dev, reg, taxa, enc, lanes, lut, taxa.numel(), n_ids, reg.shape[0], p
    )
    return reg


def update_core(
    reg: torch.Tensor,  # uint8 [P, m] register pool (updated in place)
    kmer_counts: torch.Tensor,  # int64 [T] (updated in place)
    read_counts: torch.Tensor,  # int64 [T] (updated in place)
    lut: torch.Tensor | None,  # int32 [T] id -> register row; None: rows are ids
    taxa_dense: torch.Tensor,  # int32 [B, W]
    enc: torch.Tensor,  # int32 [B, W] (uint32 bit patterns)
    hll_lanes: torch.Tensor,  # bool [B, W]
    call_dense: torch.Tensor,  # int32 [B]
    row_valid: torch.Tensor,  # bool [B]
    p: int,
    unit_id: torch.Tensor | None = None,  # integer [B]: work-unit index per row
    sparse_cap: int = 0,  # >0: also return sparse-exact stats (buf, n_p, n_e)
    counts_only: bool = False,  # skip registers and tracking
    plain: bool = False,  # the kernels' plain versions, on any device
):
    """One work unit's accumulation. Where the JAX package returns new
    arrays, the port updates the state tensors in place (they are the
    run's only copy) and returns them, followed by the sparse stats. The
    JAX package's three register layouts are one kernel here: `lut` None
    is its identity pool, a lut its two translated forms."""
    stats = sparse_stats_core if plain else sparse_stats
    sp = (
        stats(taxa_dense, enc, hll_lanes, unit_id, p, sparse_cap)
        if sparse_cap > 0 and not counts_only
        else ()
    )
    if plain:
        taxon_counts_plain(read_counts, call_dense, row_valid)
        taxon_counts_plain(kmer_counts, taxa_dense, hll_lanes)
    else:
        taxon_counts_pair(read_counts, call_dense, row_valid, kmer_counts, taxa_dense, hll_lanes)
    if not counts_only:
        regmax = hll_regmax_plain if plain else hll_regmax
        regmax(reg, taxa_dense, enc, hll_lanes, lut, p)
    return (reg, kmer_counts, read_counts) + sp


class DeviceCounters:
    def __init__(
        self,
        n_taxa: int,
        p: int = 12,
        pool_dense: np.ndarray | None = None,
        sparse_cap: int = 1 << 17,
        counts_only: bool = False,
        host_stats: bool = False,
        device="cuda",
    ):
        """pool_dense: the dense taxon ids that can ever be COUNTED -- the
        distinct database values (misses count under 0). None: register rows
        are the id space (value-pool ids). sparse_cap: per-update buffer
        slots for the sparse-exact stats (0 = estimate-compat only).
        counts_only: read and k-mer counters only, over a one-row register
        pool and with no sparse tracking (--exact: the distinct-k-mer sets
        fold on the host). host_stats: keep the sparse-regime tracking but
        compute the stats on the HOST from the fetched planes -- still
        bit-exact, used when ids exceed the device packing's 2^TAXON_BITS
        taxon field. device: where the state lives, the card unless the
        caller asks for the CPU (the Classifier passes its own device)."""
        self.p = p
        self.m = 1 << p
        self.n_taxa = n_taxa
        self.device = torch.device(device)
        self.counts_only = counts_only
        self.host_stats = host_stats and not counts_only
        self.sparse_cap = 0 if (counts_only or self.host_stats) else sparse_cap
        self.tracker = SparseTracker(device) if (self.sparse_cap > 0 or self.host_stats) else None
        self.sparse_entries = 0  # buffer slots folded by finish_sp (pairs and events)
        dev = self.device
        if counts_only:
            self.pool = np.zeros(1, dtype=np.int64)  # the register plane is unused
            self.lut = None
        elif pool_dense is None:
            self.pool = np.arange(n_taxa, dtype=np.int64)
            self.lut = None
        else:
            self.pool = np.unique(np.concatenate([[0], np.asarray(pool_dense, np.int64)]))
            lut = np.zeros(n_taxa, dtype=np.int32)  # unpooled taxa alias row 0
            lut[self.pool] = np.arange(len(self.pool), dtype=np.int32)
            # row 0 is the taxid-0 (miss) row: only counted taxa reach the
            # register update and every counted taxon is in the pool
            self.lut = torch.from_numpy(lut).to(dev)
        self.reg = torch.zeros((len(self.pool), self.m), dtype=torch.uint8, device=dev)
        self.kmer_counts = torch.zeros(n_taxa, dtype=torch.int64, device=dev)
        self.read_counts = torch.zeros(n_taxa, dtype=torch.int64, device=dev)

    def state(self):
        """The state tensors, which the update changes in place."""
        return self.reg, self.kmer_counts, self.read_counts

    def update(self, taxa_dense, enc, hll_lanes, call_dense, row_valid, unit_id=None) -> None:
        """Fold one work unit's device planes into the state. Consumes the
        sparse-exact buffer synchronously; a buffer overflow redoes the
        unit's stats on the host from the planes."""
        if self.tracker is not None and unit_id is None:
            unit_id = torch.zeros(taxa_dense.shape[0], dtype=torch.int64, device=taxa_dense.device)
        if self.host_stats:
            self.consume_host(taxa_dense, enc, hll_lanes, unit_id)
        out = update_core(
            *self.state(), self.lut, taxa_dense, enc, hll_lanes, call_dense, row_valid, self.p,
            unit_id, self.sparse_cap, self.counts_only,
        )
        if self.sparse_cap > 0 and not self.consume_sp(out[3:]):
            self.consume_host(taxa_dense, enc, hll_lanes, unit_id)

    def consume_sp(self, sp) -> bool:
        """Fold one sparse-stats buffer's USED prefix; False = overflow,
        the caller must fall back to host stats."""
        return self.finish_sp(self.start_sp(sp))

    def start_sp(self, sp, stream=None) -> dict:
        """Start the fetch of a sparse-stats buffer's two counts: on the
        card, a copy into pinned host memory on `stream` (after the work
        queued on the current stream) that the host does not wait for.
        Returns what finish_sp reads."""
        buf, n_p, n_e = sp
        if buf.device.type != "cuda":
            return {"buf": buf, "counts": (n_p, n_e), "event": None}
        stream = stream or torch.cuda.current_stream(buf.device)
        stream.wait_stream(torch.cuda.current_stream(buf.device))
        counts = torch.empty(2, dtype=torch.int32, pin_memory=True)
        with torch.cuda.stream(stream):
            counts[0].copy_(n_p, non_blocking=True)
            counts[1].copy_(n_e, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        # n_p and n_e stay referenced until finish_sp has waited for the
        # copy: the fetch stream reads them
        return {"buf": buf, "counts": counts, "event": event, "device_counts": (n_p, n_e)}

    def finish_sp(self, pending) -> bool:
        """Read a started buffer's counts and fold its USED prefix into the
        tracker on the device; False = overflow, the caller must fall back
        to host stats."""
        if pending["event"] is not None:
            pending["event"].synchronize()
        n_p, n_e = (int(x) for x in pending["counts"])
        if not self.tracker.consume_buffer(pending["buf"], n_p, n_e):
            return False
        self.sparse_entries += n_p + n_e
        return True

    def consume_host(self, taxa_dense, enc, hll_lanes, unit_id=None, unit_bounds=None) -> None:
        """Host-side sparse stats of one update's planes (fetched here),
        split into work units by row: at `unit_bounds` (row offsets), or
        where `unit_id` changes (the overflow and host-stats form)."""
        if unit_bounds is None:
            u = unit_id.cpu().numpy()
            unit_bounds = [0, *(np.flatnonzero(u[1:] != u[:-1]) + 1).tolist(), len(u)]
        self.tracker.add(*sparse_stats_host(
            taxa_dense.cpu().numpy(), enc.cpu().numpy().view(np.uint32),
            hll_lanes.cpu().numpy(), unit_bounds, self.m // 4,
        ))

    def finalize(self, taxid_of_dense: np.ndarray) -> dict[int, ReadCounts]:
        """Fetch the device state and build the taxon_counts map. With
        sparse tracking, taxa that never went dense in any work unit get a
        SPARSE HLL holding the union of their units' distinct encodings --
        the exact final state of the reference's unit-merge fold. With
        counts_only, each taxon's k-mer set is an empty ExactCounter: the
        caller's host fold supplies the sets."""
        kmer_counts = self.kmer_counts.cpu().numpy()
        read_counts = self.read_counts.cpu().numpy()
        active = np.flatnonzero((kmer_counts > 0) | (read_counts > 0))
        pool_row = np.full(self.n_taxa, -1, np.int64)
        pool_row[self.pool] = np.arange(len(self.pool))
        regs_all = self.reg.cpu().numpy()  # [P, m]: one bulk transfer
        dense_ever = self.tracker.dense_ever if self.tracker is not None else set()
        out: dict[int, ReadCounts] = {}
        for dense in active.tolist():
            nk = int(kmer_counts[dense])
            if self.counts_only:
                h = ExactCounter()
            elif self.tracker is not None and dense not in dense_ever:
                h = HLL(self.p, sparse=True)
                h.sparse_set = self.tracker.sparse_set_of(dense)
                h.n_observed = nk
            else:
                h = HLL(self.p, sparse=False)
                r = pool_row[dense]
                h.M = regs_all[r].copy() if r >= 0 else np.zeros(self.m, np.uint8)
                h.n_observed = nk
            rc = ReadCounts(h)
            rc.n_kmers = nk
            rc.n_reads = int(read_counts[dense])
            out[int(taxid_of_dense[dense])] = rc
        return out
