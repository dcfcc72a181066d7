"""End-to-end classification driver on a torch device.

Counterpart of krakenuniq_tpu/classify/pipeline.py for the single-device
path. Reads are cut into work units (greedy >=
500 kbp, the deterministic partition of classify.cpp:511-521). Two routes:

  * the span route (the default, as in the JAX package): the port's native
    module (kuniq_native_torch, _native_build.py) parses 32 MB input chunks
    and packs up to SPAN_READS reads (whole work units) into one
    bit-packed span; one device step per span emits each read's RLE row
    (`pack_runs`) and the u16/u32 HLL feed, which come back on a side
    stream into pinned buffers while newer spans run (PIPELINE_DEPTH in
    flight); the host folds the HLL feed per work unit and formats the
    kraken lines in C++. With `device_counters` the step updates the
    device counters in the same stream instead of emitting the feed, and
    the host folds only the span's sparse-stats buffer. Id spaces past u16
    (no value pool over a large taxonomy) take a per-span taxon dictionary
    (`local_dict`); a span past its capacity is redispatched on the wide
    rows;
  * the Python host route: each unit is padded into a bucketed (B, LB)
    batch, classified by one step and formatted in Python. It serves
    `use_native=False`, `print_sequence` and the span route's fallback
    chunks (multi-line FASTA, reads longer than `max_read_len`).

A read longer than `max_read_len` (the long-read route, JAX pipeline.py:
1876-1965) is cut into chunks of max_read_len bases that overlap by k - 1,
looked up by one step without the device's tree resolution (whose per-read
resolve is quadratic in the row's width) and resolved on the host; its
lanes fold into the unit's counts on the host. `exact` counts each taxon's
distinct canonical k-mers (the step's canon plane, `kmer_front`'s optional
output) instead of HLL estimates; with `device_counters` the read and
k-mer counters stay on the device (counts only) and the k-mer sets fold on
the host.

Out of core (`preload_size`, the reference's --preload-size) the tables do
not stay on the card: each database is cut into minimizer-range chunk
tables (db/chunked.py) that stream through one or two device slots on a
copy stream, and every chunk folds its hits into each span's word plane
(`probe_chunk_core`: only the lanes whose minimizer bin the chunk owns are
probed); the finish step then reads that plane in place of the tables
(lookup_mode "acc"). On the span route the spans gather into groups
of `ooc_group_bytes`, and each group takes one pass of the chunk tables
(classify.cpp:587-648's outer chunk loop).

The resident lookup is the hash table of every database (lookup_mode
"hash": CHD, or the fused layout a failed CHD build falls back to). When a
database's table build fails altogether, every database is searched in its
sorted planes instead (lookup_mode "bsearch", in dense ids), as in the JAX
package; the planes of the databases that did build a table go to the
device once for it.

UID databases (`uid_database=True`, the reference's --uid-mapping) load
`uid_database.kdb`, whose values are taxon-set ids: the table stores them
raw in the two-level layout (the `rows_probe` kernel; `rows_probe_acc` out
of core), the step returns them as the "taxa" plane and the span route runs
on the wide rows (no dictionary), and each read's call is resolved on the
host from its k-mers' sets (classify/uid.py, resolve_uids3). The k-mer
counters key on the raw ids, the read counts on the resolved taxids.

A mesh (`mesh_data` x `mesh_db` > 1, parallel/mesh.py) runs one Classifier
a rank, in ranks that parallel/mesh.spawn_mesh started: each rank holds its
db shard of every database's table (parallel/partition.load_sharded_db; out
of core, every n_db-th chunk table), takes the same spans of the same input
and steps its data slice of each span's rows, the words merged over its db
group inside the step; the outputs come to rank 0, which alone counts,
formats and writes. A host decision that needs another step (a dictionary
or sparse-buffer overflow) is taken on every rank: the dictionary's count
is the same on all of them, and rank 0 broadcasts the sparse buffer's.
Multi-host runs (`host_id` of `n_hosts`, parallel/multihost.py) classify
the global spans s with s % n_hosts == host_id and record each one's byte
range of the kraken output in `span_manifest`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys
from collections import deque

import numpy as np
import torch

from ..db import DeviceDB, load_database_dir
from ..db.chunked import ChunkedHashDB, ChunkSlots, load_chunked_db
from ..db.device_db import compute_vals_dense
from ..db.pool import build_value_pool
from ..formats import read_kdb
from ..formats.counts import counts_from_vals, read_counts_stream_bugcompat, write_counts
from ..formats.seqio import (
    DNASequence,
    format_sequence,
    is_fastq,
    open_maybe_compressed,
    read_fasta,
    read_fastq,
)
from ..kmer import encode_batch
from ..report import DEFAULT_COLS, FULL_COLS, NO_HLL_COLS, TaxReport
from ..taxonomy import Taxonomy
from ..utils import trace
from .accumulate import TaxonCounter
from .device_step import StepConfig, classify_and_count_core, classify_step_core, pack_input, probe_chunk_core
from .output import kraken_line
from .sparse_exact import MAX_UNITS
from .uid import UidMap, resolve_uids

WORK_UNIT_SIZE = 500_000  # bp, classify.cpp:38
# the span route: reads per span (whole work units up to this many; tail
# spans are padded to 1024, 8192 or 65536 rows, fetches cut to an 8192-row
# grid), RLE run slots per read (even; reads with more runs take overflow
# rows) and spans in flight
SPAN_READS = 65536
MAX_RUNS = 8
PIPELINE_DEPTH = 3
_CHUNK_BYTES = 32 << 20  # input bytes parsed per native chunk
_FETCH_GRID = 8192  # span rows are fetched in multiples of this
# the span step's per-row outputs the host fetches (RLE rows, the HLL feed;
# with exact, the taxa, counted lanes and canonical k-mers)
_SPAN_FETCH = ("packed", "hll_enc", "hll_dense")
_EXACT_FETCH = ("taxa", "hll_lanes", "canon")
# under a UID database: the wide rows, their u64 HLL feed and the raw plane
# the host resolves the calls from
_UID_FETCH = ("packed", "hll_pairs", "taxa")
_EMPTY = np.empty(0, np.uint32)


@dataclasses.dataclass
class ClassifyOptions:
    quick: bool = False
    min_hits: int = 1
    # reference bug compatibility: -p never reaches an HLL constructor, every
    # counter runs at precision 12 (hyperloglogplus.hpp:87, classify.cpp:289,
    # 1094) and the flag only gates the report's unique-k-mer columns (0
    # drops them); `true_hll_precision` opts into the documented behaviour
    hll_precision: int = 12
    true_hll_precision: bool = False
    # distinct canonical k-mers per taxon instead of HLL estimates
    # (classify.cpp:44-56)
    exact: bool = False
    only_classified_output: bool = False
    # each kraken line ends with the read's sequence (the Python route)
    print_sequence: bool = False
    # device batch width cap: longer reads are cut into chunks of this many
    # bases with k - 1 overlap and resolved on the host
    max_read_len: int = 1 << 15
    min_batch_reads: int = 64  # a unit's batch height is this times a power of two
    # the report's extra columns (FULL_COLS) and taxa with no reads
    full_report: bool = False
    report_zeros: bool = False
    print_progress: bool = True
    # torch device of the tables and the step; "cuda" raises when no card
    # is present rather than falling back
    device: str = "cuda"
    # keep the entire taxon_counts state on the device and fetch it once at
    # the end (see classify/device_counters.py)
    device_counters: bool = False
    # --device-counters sparse-exact buffer slots per work unit (u64 each):
    # the sparse-regime tracking makes the mode BIT-IDENTICAL to the host
    # fold (classify/sparse_exact.py); 0 opts out (estimate-level compat).
    # Only the USED prefix is fetched. A unit overflowing the buffer redoes
    # its stats on the host (counted in dev_counters.tracker.overflows).
    sparse_cap: int = 1 << 21
    # value pool (db/pool.py): index the device id space by the databases'
    # LCA-closed value set when it fits u16; False forces dense taxonomy ids
    # (and the per-span dictionary on the span route past 65,535 ids)
    value_pool: bool = True
    # per-span taxon dictionary capacity (< 0xFFFF): a span touching more
    # distinct taxa is redispatched on the wide RLE rows
    dict_capacity: int = 1 << 15
    # the span route (native parser, packed spans, RLE rows); False takes
    # the Python host route
    use_native: bool = True
    # out-of-core (--preload-size): device byte budget for the database
    # tables. When the databases' hash tables exceed it, they are split into
    # minimizer-range chunk tables streamed through the card one after
    # another, with hits folded into a per-span device accumulator (the
    # temporal generalization the reference runs at classify.cpp:566-791).
    # None/0 = everything resident.
    preload_size: int | None = None
    # out-of-core span grouping: spans whose accumulators and inputs fit
    # this budget share one pass of the chunk tables through the card (the
    # analogue of the reference re-reading all reads per chunk,
    # classify.cpp:587-648)
    ooc_group_bytes: int = 2 << 30
    # double-buffer the chunk stream: plan chunks at HALF the preload
    # budget so the next chunk table uploads while the current one's probes
    # run; total resident bytes stay within --preload-size. Falls back to
    # single-buffering when half the budget cannot hold a legal chunk.
    ooc_double_buffer: bool = True
    # a mesh of mesh_data x mesh_db ranks (parallel/mesh.py): the tables
    # minimizer-sharded over mesh_db ranks, each span's rows over mesh_data;
    # the Classifier must be built in every rank of a torch.distributed world
    # of that size (parallel/mesh.spawn_mesh starts one). 1x1 = one device
    mesh_data: int = 1
    mesh_db: int = 1
    # multi-host input sharding: this process classifies the global spans s
    # with s % n_hosts == host_id (parallel/multihost.py)
    host_id: int = 0
    n_hosts: int = 1
    # the span geometry: a work unit's bases (None: WORK_UNIT_SIZE) and a
    # span's reads (None: SPAN_READS)
    work_unit_size: int | None = None
    device_batch_reads: int | None = None


def _bucket(n: int, lo: int, step: int = 2) -> int:
    """Round a batch dimension up to lo times a power of `step` (spans use
    step 8: 1024, 8192, 65536 rows)."""
    b = lo
    while b < n:
        b *= step
    return b


def _unit_bounds(seq_lens, size: int | None = None) -> list[int]:
    """Greedy >= size (WORK_UNIT_SIZE) bp work units (classify.cpp:511-521)
    over a chunk's read lengths: [0, end of unit 1, ...]; a last unit short
    of the size has no end in the list."""
    size = size or WORK_UNIT_SIZE
    bounds = [0]
    acc = 0
    for i, m in enumerate(seq_lens):
        acc += m
        if acc >= size:
            bounds.append(i + 1)
            acc = 0
    return bounds


def _bucket_len(n: int, lo: int) -> int:
    """Read-length padding bucket: multiples of 32 up to 512 (the W^2 tree
    resolution makes width padding quadratic), then powers of two."""
    if n <= lo:
        return lo
    if n <= 512:
        return (n + 31) // 32 * 32
    b = 512
    while b < n:
        b *= 2
    return b


def _check_dense_resolve_capacity(t_size: int) -> None:
    """Euler times run to 2*T and must stay below 2^28 for the score
    sentinels (taxonomy/resolve.py)."""
    if 2 * t_size > (1 << 28):
        raise ValueError(
            f"taxonomy too large for dense-mode tree resolution "
            f"({t_size} nodes; Euler keys need 2*T <= 2^28) -- "
            "use the value pool (default) or split the taxonomy"
        )


def resolve_device(name: str) -> torch.device:
    """The torch device for `name`; "cuda" without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available "
            "(pass device='cpu' / --device cpu to run on the CPU)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


class Classifier:
    def __init__(self, db_dirs: list[str], options: ClassifyOptions | None = None,
                 uid_database: bool = False, _shared: "Classifier | None" = None):
        """`uid_database`: the databases' `uid_database.kdb` and
        `uid_to_taxid.map` (the reference's --uid-mapping), one database
        and no quick mode (JAX pipeline.py:196-216)."""
        with trace.span("load"):
            self.opts = options or ClassifyOptions()
            self.device = resolve_device(self.opts.device)
            self.mesh = None
            if self.opts.mesh_data * self.opts.mesh_db > 1:
                from ..parallel.mesh import make_mesh

                self.mesh = make_mesh(self.opts.mesh_data, self.opts.mesh_db, self.opts.device)
                self.device = self.mesh.device
            # rank 0 of a mesh (or the one process) counts, formats and writes
            self._is_root = self.mesh is None or self.mesh.is_root
            self.db_dirs = [os.fspath(d) for d in db_dirs]
            self._uid_database = uid_database
            if uid_database:
                if self.opts.quick:
                    raise ValueError("Quick mode not available when mapping UIDs")
                if len(self.db_dirs) > 1:
                    raise ValueError("Cannot use more than one database with UID mapping!")
            if _shared is not None:
                self._adopt_loaded(_shared)
            else:
                self.uid_map = UidMap(os.path.join(self.db_dirs[0], "uid_to_taxid.map")) if uid_database else None
                self._load()
            self._configure()

    @classmethod
    def with_shared_db(cls, other: "Classifier", options: ClassifyOptions | None = None,
                       **changes) -> "Classifier":
        """A new Classifier reusing `other`'s loaded databases (host arrays
        AND the device tables) under other run options: `options`, or
        `other`'s options with `changes` applied. The device tables are
        GB-sized at reference scale; sharing them is the difference between
        an option swap and a reload."""
        opts = options or dataclasses.replace(other.opts, **changes)
        if (opts.mesh_data, opts.mesh_db) != (other.opts.mesh_data, other.opts.mesh_db):
            raise ValueError("cannot share DB state across mesh configurations")
        if other.mesh is None and resolve_device(opts.device) != other.device:
            raise ValueError(f"cannot share {other.device} tables on {opts.device}")
        if opts.value_pool != other.opts.value_pool:
            raise ValueError("cannot share tables across value_pool settings")
        if opts.preload_size and other._ooc is None:
            raise ValueError("cannot share resident DB state into out-of-core mode")
        return cls(other.db_dirs, opts, other._uid_database, _shared=other)

    def _adopt_loaded(self, other: "Classifier") -> None:
        # out of core: the host chunk tables and the device slots they
        # stream through
        for name in ("taxonomy", "uid_map", "dbs", "k", "nt", "_pool", "_ooc", "_ooc_slots", "_ooc_budget",
                     "mesh", "device"):
            setattr(self, name, getattr(other, name))

    def _estimate_table_bytes(self, pooled: bool = True) -> int:
        """Resident-table device bytes across databases, from the kdb headers
        alone (dense values are bounded by the taxonomy size). `pooled`
        narrows the value field to the pool cap, which holds only if the
        value pool builds: in the zone between the two estimates the caller
        must build it to know."""
        from ..db.chunked import table_bytes
        from ..db.pool import POOL_CAP
        from ..formats.kdb import read_header

        uid = self._uid_database
        max_val = self.taxonomy.size - 1
        if pooled and self.opts.value_pool and not uid:
            max_val = min(max_val, POOL_CAP)
        kdb = "uid_database.kdb" if uid else "database.kdb"
        return sum(table_bytes(read_header(os.path.join(d, kdb)).key_ct, max_val, uid) for d in self.db_dirs)

    def _load(self) -> None:
        with trace.span("load.taxonomy"):
            self.taxonomy = Taxonomy.from_taxdb_file(os.path.join(self.db_dirs[0], "taxDB"))
        self._ooc: list[ChunkedHashDB] | None = None  # the chunk tables, out of core
        self._ooc_slots = None
        ps = self._ooc_budget = self.opts.preload_size or 0
        # kdb reads shared between the pool build and the loaders: only the
        # dense values are kept across databases
        pre_vd: dict[str, np.ndarray] = {}

        def joint_pool():
            # hierarchical lookups merge into ONE taxon plane
            # (classify.cpp:927-936): every table speaks one joint id space
            for d in self.db_dirs:
                if d not in pre_vd:
                    _, _, v = read_kdb(os.path.join(d, "database.kdb"))
                    pre_vd[d] = compute_vals_dense(v, self.taxonomy)
            return build_value_pool([pre_vd[d] for d in self.db_dirs], self.taxonomy)

        # value pool (db/pool.py): device ids index the databases'
        # LCA-closed value set when it fits u16, else dense taxonomy ids (a
        # UID database stores raw set ids: no pool)
        pool_arg = "auto" if self.opts.value_pool and not self._uid_database else None
        if len(self.db_dirs) > 1 and self.opts.value_pool:
            pool_arg = joint_pool()
        use_ooc = False
        # under a mesh the budget is a rank's: the shards hold n_db times it
        capacity = ps * (self.mesh.n_db if self.mesh is not None else 1)
        if ps and self._estimate_table_bytes(pooled=False) > capacity:
            if self._estimate_table_bytes(pooled=True) > capacity or pool_arg is None:
                use_ooc = True
            else:
                # between the estimates: resident only if the value pool
                # actually builds (the closure fits u16)
                if pool_arg == "auto":
                    pool_arg = joint_pool()
                use_ooc = pool_arg is None
        self.dbs: list[DeviceDB] = []
        if use_ooc:
            self._ooc = self._load_chunked(ps, pool_arg, pre_vd)
            self._pool = self._ooc[0].pool
            self._check_widths([c.k for c in self._ooc], [c.nt for c in self._ooc])
            return
        if self.mesh is not None:
            # this rank's shard of every database's table, one id space
            # (JAX pipeline.py:356-450)
            from ..parallel.partition import load_sharded_db

            for i, d in enumerate(self.db_dirs):
                with trace.span("load.tables", db=i):
                    self.dbs.append(load_sharded_db(d, self.mesh, self.taxonomy, pool=pool_arg,
                                                    vals_dense=pre_vd.get(d), uid_database=self._uid_database))
            self._check_widths([db.k for db in self.dbs], [db.nt for db in self.dbs])
            self._pool = self.dbs[0].pool
            return
        for i, d in enumerate(self.db_dirs):
            with trace.span("load.tables", db=i):
                db, _ = load_database_dir(
                    d, taxonomy=self.taxonomy, device=self.device, pool=pool_arg,
                    vals_dense=pre_vd.get(d), uid_database=self._uid_database,
                )
            self.dbs.append(db)
        if any(db.pool is None for db in self.dbs) and any(db.pool is not None for db in self.dbs):
            # a fallback to the binary search dropped one database's pool;
            # mixed id spaces are invalid, so every database is reloaded with
            # dense ids (krakenuniq_tpu/classify/pipeline.py:463-474)
            self.dbs = []
            for i, d in enumerate(self.db_dirs):
                with trace.span("load.tables", db=i):
                    self.dbs.append(load_database_dir(d, taxonomy=self.taxonomy, device=self.device, pool=None,
                                                      vals_dense=pre_vd.get(d))[0])
        self._check_widths([db.k for db in self.dbs], [db.nt for db in self.dbs])
        self._pool = self.dbs[0].pool

    def _check_widths(self, ks, nts) -> None:
        """One k-mer and one minimizer size across the databases; sets them."""
        if len(set(ks)) != 1:
            raise ValueError(f"Different k-mer sizes in databases: {sorted(set(ks))}")
        if len(set(nts)) != 1:
            raise ValueError(f"Different minimizer sizes in databases: {sorted(set(nts))}")
        self.k, self.nt = ks[0], nts[0]

    def _load_chunked(self, ps: int, pool_arg, pre_vd: dict) -> list[ChunkedHashDB]:
        """Every database as chunk tables (db/chunked.py), pinned for a card.
        Double-buffered streaming plans at half the budget, so that two
        chunk tables fit it at once; when half the budget cannot hold a legal
        chunk table, the chunks are planned at the full budget (and stream
        through one slot). Under a mesh the budget is a rank's and each
        database's chunk count a multiple of n_db (a group of chunks, one a
        db rank)."""
        pin = self.device.type == "cuda"
        multiple = self.mesh.n_db if self.mesh is not None else 1

        def build(budget):
            out = []
            for i, d in enumerate(self.db_dirs):
                with trace.span("load.tables", db=i):
                    out.append(load_chunked_db(d, budget, self.taxonomy, pool=pool_arg, vals_dense=pre_vd.get(d),
                                               pin=pin, uid_database=self._uid_database, chunk_multiple=multiple))
            return out

        if self.opts.ooc_double_buffer:
            try:
                return build(max(ps // 2, 1))
            except ValueError:
                pass
        return build(ps)

    def _vals_dense(self, i: int) -> np.ndarray:
        """Database i's values as dense taxonomy ids (host)."""
        return self.dbs[i].vals_dense if self._ooc is None else self._ooc[i].vals_dense

    def _configure(self) -> None:
        tax, pool = self.taxonomy, self._pool
        exact = self.opts.exact
        self._effective_p = self.opts.hll_precision if self.opts.true_hll_precision else 12
        if pool is not None:
            # pool mode: resolve tables are [P]-sized and the tie-LCA walk
            # runs on the closure parent chain
            taxids, tin, tout, parent = pool.taxids, pool.tin, pool.tout, pool.parent
            self._root_dense = int(pool.root)
            step_depth = pool.max_depth
        else:
            _check_dense_resolve_capacity(tax.size)
            taxids, tin, tout, parent = tax.taxids, tax.tin, tax.tout, tax.parent
            self._root_dense = int(tax.dense_index(np.asarray([1], dtype=np.uint32))[0])
            step_depth = tax.max_depth

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        self._taxids_host = np.ascontiguousarray(taxids, dtype=np.uint32)
        self._taxid_table = put(self._taxids_host.view(np.int32), np.int32)
        # the resolve's [T, 2] (tin, tout) table, gathered per k-mer lane
        self._io = put(np.stack([tin, tout], axis=1), np.int32)
        self._parent = put(parent, np.int32)
        lookup_mode, n_iter = "acc", 1
        if self._ooc is None:
            # the hash tables only if every database has one; else every
            # database's sorted planes, on the device once (JAX pipeline.py:
            # 556-566)
            if all(db.hash_table is not None for db in self.dbs):
                lookup_mode = "hash"
                self._db_planes = tuple(db.hash_table for db in self.dbs)
            else:
                lookup_mode = "bsearch"
                n_iter = max(db.search_iters for db in self.dbs)
                self._db_planes = tuple(
                    (*db.upload_sorted_planes(self.device), db.bin_start) for db in self.dbs
                )
            self._ooc_prefetch = False
        else:
            # the chunk tables stream through the slots (_ooc_probe_group);
            # the step reads each span's merged word plane instead
            self._db_planes = None
            if self._ooc_slots is None:
                self._ooc_slots = ChunkSlots(self._ooc, self.device)
            self._ooc_prefetch = self.opts.ooc_double_buffer and (
                2 * max(c.chunk_bytes() for c in self._ooc) <= self._ooc_budget)
        uid = self.uid_map is not None
        self._cfg = StepConfig(
            k=self.k,
            max_depth=step_depth,
            hll_p=self._effective_p,
            quick=self.opts.quick,
            min_hits=self.opts.min_hits,
            lookup_mode=lookup_mode,
            nt=self.nt,
            n_iter=n_iter,
            with_kmers=exact,
            # a UID database's words are raw set ids, in every lookup mode
            raw_dbs=(True,) * len(self.db_dirs) if uid else (),
        )
        # device-counters sparse tracking: ids past the device packing's
        # 2^TAXON_BITS taxon field fall back to HOST-computed per-unit stats
        # -- slower (three planes fetched) but still bit-exact
        from . import sparse_exact

        self._dc_host_stats = (
            self.opts.device_counters
            and not exact
            and self.opts.sparse_cap > 0
            and (len(self.uid_map) + 1 >= (1 << sparse_exact.TAXON_BITS) if uid
                 else pool is None and tax.size >= (1 << sparse_exact.TAXON_BITS))
        )
        if self._dc_host_stats:
            print(
                "note: id space exceeds the device sparse-stats packing "
                f"(2^{sparse_exact.TAXON_BITS}); sparse-regime tracking runs on "
                "host (slower, still bit-exact)",
                file=sys.stderr,
            )
        # the span route, as in the JAX package (krakenuniq_tpu/classify/
        # pipeline.py:597-701): compact RLE rows of u16 ids, through a
        # per-span taxon dictionary when the id space passes u16; a kraken
        # line that carries the sequence needs the Python route's records
        self.route = "span" if self.opts.use_native and not self.opts.print_sequence else "python"
        local_dict = pool is None and tax.size > 0xFFFF and not uid
        if local_dict and not 0 < self.opts.dict_capacity < 0xFFFF:
            raise ValueError(f"dict_capacity must be in (0, 0xFFFF), got {self.opts.dict_capacity}")
        if exact:
            # the distinct-k-mer sets fold on the host from the canon plane;
            # device counters (counts only) ride the same step
            span_outputs = ("packed", "taxa", "ambig", "hll_lanes", "canon")
        elif uid:
            # the wide rows of raw ids (JAX pipeline.py:594-598, 640-651):
            # the host resolves the calls from the raw plane; the device
            # counters key on it in the step's stream
            span_outputs = ("packed", "taxa", "ambig")
            if not self.opts.device_counters:
                span_outputs += ("hll_pairs",)
            elif self._dc_host_stats:
                span_outputs += ("enc", "hll_lanes")
        elif self.opts.device_counters:
            # the counts and registers update on the card in the step's
            # stream; the host reads the rows and the overflow rows' planes
            span_outputs = ("packed", "taxa_dense", "ambig")
            if self._dc_host_stats:
                span_outputs += ("enc", "hll_lanes")
        else:
            span_outputs = ("packed", "taxa_dense", "ambig", "hll_enc", "hll_dense")
        if local_dict:
            span_outputs += ("lut",)
        self._cfg_packed = dataclasses.replace(
            self._cfg,
            packed_input=True,
            max_runs=MAX_RUNS,
            dense_runs=not uid,
            local_dict=local_dict,
            dict_capacity=self.opts.dict_capacity,
            outputs=span_outputs,
        )
        # the dictionary's overflow program: the same span on the wide rows
        # (taxids) with the u64 feed in place of the u16 one
        self._cfg_packed_wide = None
        if local_dict:
            wide = tuple(k for k in span_outputs if k not in ("hll_enc", "hll_dense", "lut"))
            if "hll_dense" in span_outputs:
                wide += ("hll_pairs",)
            self._cfg_packed_wide = dataclasses.replace(
                self._cfg_packed, dense_runs=False, local_dict=False, outputs=wide
            )
        # the sparse buffer's overflow program: the planes of the host stats
        # (under UID the counters key on the raw plane)
        self._fb_id_key = "taxa" if uid else "taxa_dense"
        self._cfg_sparse_fb = dataclasses.replace(
            self._cfg_packed, outputs=(self._fb_id_key, "enc", "hll_lanes")
        )
        self._span_fetch = (_UID_FETCH if uid else _SPAN_FETCH) + (_EXACT_FETCH if exact else ())
        # D2H copies of the spans' rows and HLL feed run on their own stream
        self._fetch_stream = (
            torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        )
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero all accumulation state so the same loaded Classifier can run
        another input from scratch."""
        self._init_counters()
        self.total_sequences = 0
        self.total_bases = 0
        self.total_classified = 0
        # Sums of the run's spans (utils/trace.py). Python route: the
        # "unit.step" spans (upload, kernels, fetch) and the rest of the
        # "unit" spans (encode, accumulate, format). Span route: the host's
        # seconds, by stage in span_host_seconds, each the self time of its
        # "span.<stage>" spans (encode; step: the launches and the resolve's
        # waits on the card; probe: out of core, the "ooc.group" spans, the
        # launches of a group's chunk passes; uid: the host's resolve of the
        # UID calls, one read at a time; counters: the sparse buffer's fetch
        # and fold and its overflow fallback; fold: the host's HLL fold;
        # format; not the "span.fetch_wait" spans), the card's (CUDA events
        # around upload and step; on the CPU the "span.step.cpu" spans) and
        # the fetch copies' (CUDA events on the fetch stream).
        self.device_seconds = 0.0
        self.host_seconds = 0.0
        self.fetch_seconds = 0.0
        self.span_host_seconds = {"encode": 0.0, "step": 0.0, "probe": 0.0, "uid": 0.0, "counters": 0.0,
                                  "fold": 0.0, "format": 0.0}
        self.n_units = 0
        self.n_spans = 0
        self.n_long_reads = 0  # reads classified by the long-read route
        self.dict_overflows = 0  # spans redispatched on the wide rows
        # out of core: chunk-table passes (groups) and, on a card, the CUDA
        # events of each chunk copy (copy stream), each chunk's probes of a
        # group and each group's whole pass (step stream), folded into
        # milliseconds in ooc_times as the card passes them (ooc_timings())
        self.ooc_groups = 0
        self._ooc_events = {"upload": [], "probe": [], "group": []}
        self.ooc_times = {kind: [] for kind in self._ooc_events}

    def _init_counters(self) -> None:
        p = self._effective_p
        self.counter = TaxonCounter(p, exact=self.opts.exact)
        self.dev_counters = None
        if not self.opts.device_counters or not self._is_root:  # a mesh counts on rank 0
            return
        from .device_counters import DeviceCounters

        pool, tax = self._pool, self.taxonomy
        if self.opts.exact:
            # read and k-mer counters on the device; the distinct-k-mer sets
            # fold on the host from the canon plane the exact step returns
            # anyway (classify.cpp:44-56 counts exactly in every mode)
            n = pool.size if pool is not None else tax.size
            self.dev_counters = DeviceCounters(n, p, counts_only=True, device=self.device)
        elif self.uid_map is not None:
            # UID databases: the k-mer counters and registers key on the raw
            # stored id (the reference counts under the uid value,
            # classify.cpp:939, 953-959); the read counts key on the
            # host-resolved taxid and fold through self.counter
            self.dev_counters = DeviceCounters(
                len(self.uid_map) + 1, p, pool_dense=self._uid_value_set(), sparse_cap=self.opts.sparse_cap,
                host_stats=self._dc_host_stats, device=self.device,
            )
        elif pool is not None:
            # pool mode: the device id space IS the value closure --
            # registers and counters are pool-width and rows are ids
            self.dev_counters = DeviceCounters(
                pool.size, p, sparse_cap=self.opts.sparse_cap, device=self.device
            )
        else:
            # registers only ever accumulate under DB values: restrict the
            # plane to the value set so it scales with the database, not the
            # taxonomy (a 2.4M-node taxDB would otherwise cost 10 GB)
            reg_pool = np.unique(np.concatenate([np.unique(self._vals_dense(i)) for i in range(len(self.db_dirs))]))
            self.dev_counters = DeviceCounters(
                tax.size, p, pool_dense=reg_pool, sparse_cap=self.opts.sparse_cap,
                host_stats=self._dc_host_stats, device=self.device,
            )

    def _uid_value_set(self) -> np.ndarray:
        """The distinct raw ids stored in the UID database: the register
        rows of the device counters."""
        if self.dbs and self.dbs[0].vals is not None:
            return np.unique(self.dbs[0].vals)
        _, _, vals = read_kdb(os.path.join(self.db_dirs[0], "uid_database.kdb"))
        return np.unique(vals)

    def _resolve_uid_calls(self, taxa, n_kmers, calls, n: int) -> np.ndarray:
        """Each of the first n reads' call from its k-mers' raw ids (u32 [n,
        W], the first n_kmers[i] of row i), by resolve_uids3 (JAX
        pipeline.py:1860-1871), a Python loop over the reads; `calls` as
        they are without a UID database."""
        if self.uid_map is None:
            return calls
        out = np.empty(n, dtype=np.uint32)
        for i in range(n):
            row = taxa[i, : int(n_kmers[i])]
            hits: dict[int, int] = {}
            for u in row[row != 0].tolist():
                hits[u] = hits.get(u, 0) + 1
            out[i] = resolve_uids(hits, self.uid_map, self.taxonomy.lca_fold)
        return out

    # ------------------------------------------------------------ unit input

    def _work_units(self, path: str):
        """Greedy >= WORK_UNIT_SIZE bp batches in read order (classify.cpp:511-521)."""
        size = self.opts.work_unit_size or WORK_UNIT_SIZE
        fastq = is_fastq(path)
        with open_maybe_compressed(path, "rt") as fh:
            reader = read_fastq(fh) if fastq else read_fasta(fh)
            unit: list[DNASequence] = []
            total_nt = 0
            for dna in reader:
                unit.append(dna)
                total_nt += len(dna.seq)
                if total_nt >= size:
                    yield unit, fastq
                    unit, total_nt = [], 0
            if unit:
                yield unit, fastq

    # ------------------------------------------------------------- main loop

    def run(self, input_paths: list[str], kraken_fh=None, classified_fh=None,
            unclassified_fh=None) -> None:
        """Classify the inputs; under a mesh every rank runs this over the
        same inputs, and only rank 0's output handles are written."""
        with trace.span("run", run=trace.new_run()) as sp:
            # the global span numbering of multi-host runs (work units on the
            # Python route), across the input files
            self._span_counter = 0
            self.span_manifest = []  # [(global span index, byte start, byte end)]
            for path in input_paths:
                if self.route == "span":
                    run = self._run_native if self._ooc is None else self._run_native_ooc
                    run(path, kraken_fh, classified_fh, unclassified_fh)
                    continue
                for unit, fastq in self._work_units(path):
                    idx = self._claim_span()
                    if idx is None:
                        continue
                    with self._manifest_span(idx, kraken_fh):
                        self._process_unit(unit, fastq, kraken_fh, classified_fh, unclassified_fh)
                    self._progress()
        self._elapsed = sp.seconds

    def _claim_span(self) -> int | None:
        """The next global span's index, or None when another host owns it
        (parallel/multihost.owns_span: s % n_hosts == host_id)."""
        idx = self._span_counter
        self._span_counter += 1
        return idx if idx % self.opts.n_hosts == self.opts.host_id else None

    @contextlib.contextmanager
    def _manifest_span(self, span_idx: int, kraken_fh):
        """Record the kraken output's byte range of one global span in
        span_manifest (multi-host runs, on an output that can tell)."""
        b0 = None
        if self.opts.n_hosts > 1 and kraken_fh is not None:
            try:
                b0 = kraken_fh.tell()
            except (OSError, AttributeError):
                b0 = None
        yield
        if b0 is not None:
            self.span_manifest.append((span_idx, b0, kraken_fh.tell()))

    def _round_mesh(self, b: int) -> int:
        """A batch height rounded up to split evenly over the data ranks."""
        n = self.mesh.n_data if self.mesh is not None else 1
        return -(-b // n) * n

    def _progress(self):
        if self.opts.print_progress and self._is_root:
            pct = 100.0 * self.total_classified / max(self.total_sequences, 1)
            sys.stderr.write(
                f"\r Processed {self.total_sequences} sequences ({pct:.2f}% classified)"
            )

    def _device_step(self, codes, ambig, lengths, plain: bool = False, cfg: StepConfig | None = None):
        """One classify step on numpy batch arrays under `cfg` (default: the
        unpacked feed's config); returns device tensors. Out of core the
        chunk tables stream through the card for this one batch first (the
        Python route's units, fallback chunks and long reads). Under a mesh
        the step runs on this rank's rows and every rank gets the full
        outputs back."""
        dev = self.device
        b = codes.shape[0]
        if self.mesh is not None:
            rows = self.mesh.rows(b)
            codes, ambig, lengths = codes[rows], ambig[rows], lengths[rows]
        feed = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (codes, ambig, lengths))
        planes = self._db_planes
        if self._ooc is not None:
            # the chunk passes read the packed feed, packed once here
            st = {"feed": (*pack_input(feed[0], feed[1]), feed[2]), "acc": None}
            self._ooc_probe_group([st], plain=plain)
            planes = st["acc"]
        out = classify_step_core(
            planes, self._taxid_table, self._io, self._parent, self._root_dense, *feed, cfg or self._cfg,
            plain=plain, mesh=self.mesh,
        )
        return out if self.mesh is None else self.mesh.gather_rows(out, b, to_all=True)

    def _encode_unit(self, unit):
        """Pad one work unit into its bucketed (B, LB) batch; a read longer
        than max_read_len keeps a zero-length placeholder row (the long-read
        route classifies it)."""
        mrl = self.opts.max_read_len
        seqs = ["" if len(d.seq) > mrl else d.seq for d in unit]
        max_len = max((len(s) for s in seqs), default=1)
        lb = _bucket_len(max(max_len, self.k), max(128, self.k))
        b = self._round_mesh(_bucket(len(unit), self.opts.min_batch_reads))
        return encode_batch(seqs, lb=lb, batch=b)

    def _classify_long_read(self, seq: str):
        """Classify one read longer than max_read_len (JAX pipeline.py:
        1876-1965): chunks of max_read_len bases with k - 1 overlap, one step
        without the device's tree resolution, the resolve on the host.
        Returns (taxa u32 [W], ambig bool [W], enc u32 [W], call, hits,
        processed bool [W], canon u64 [W] or None without exact), W =
        len(seq) - k + 1."""
        k, opts = self.k, self.opts
        payload = opts.max_read_len - (k - 1)
        chunks = [seq[s : s + opts.max_read_len] for s in range(0, max(1, len(seq) - k + 1), payload)]
        lb = _bucket_len(max(len(c) for c in chunks), max(128, k))
        enc = encode_batch(chunks, lb=lb, batch=self._round_mesh(_bucket(len(chunks), 8)))
        cfg = dataclasses.replace(self._cfg, resolve=False, max_runs=0, quick=False)
        out = self._device_step(enc.codes, enc.ambig, enc.lengths, cfg=cfg)
        rows = [len(c) - k + 1 for c in chunks]

        def joined(key, view=None):
            a = out[key][: len(chunks)].cpu().numpy()
            a = a.view(view) if view is not None else a
            return np.concatenate([a[i, :w] for i, w in enumerate(rows)])

        taxa = joined("taxa", np.uint32)
        ambig = joined("ambig")
        enc_l = joined("enc", np.uint32)
        canon = joined("canon", np.uint64) if opts.exact else None
        hit = taxa != 0
        if opts.quick:
            cum = np.cumsum(hit)
            reach = np.flatnonzero(cum >= opts.min_hits)
            if len(reach):
                stop = int(reach[0])
                processed = np.zeros(len(taxa), bool)
                processed[: stop + 1] = True
                hits, call = opts.min_hits, int(taxa[stop])
            else:
                processed = np.ones(len(taxa), bool)
                hits, call = (int(cum[-1]) if len(cum) else 0), 0
        else:
            processed = np.ones(len(taxa), bool)
            hits = int(hit.sum())
            if self.uid_map is not None:
                # the raw ids in the order of their first hit, as the JAX
                # package folds them
                counts: dict[int, int] = {}
                for u in taxa[hit].tolist():
                    counts[u] = counts.get(u, 0) + 1
                call = int(resolve_uids(counts, self.uid_map, self.taxonomy.lca_fold))
            else:
                u, c = np.unique(taxa[hit], return_counts=True)
                call = int(self.taxonomy.resolve_tree_host(dict(zip(u.tolist(), c.tolist()))))
        return taxa, ambig, enc_l, call, hits, processed, canon

    def _process_unit(self, unit, fastq, kraken_fh, classified_fh, unclassified_fh) -> None:
        """One work unit on the Python route. Its "unit.step" span (the
        step, its fetch, the long reads) is the device's seconds and the
        rest of its "unit" span the host's."""
        with trace.span("unit") as sp:
            step = self._classify_unit(unit, fastq, kraken_fh, classified_fh, unclassified_fh)
        if step is not None:  # None: a mesh rank's share is the device steps
            self.device_seconds += step.seconds
            self.host_seconds += sp.seconds - step.seconds

    def _classify_unit(self, unit, fastq, kraken_fh, classified_fh, unclassified_fh) -> trace.Span | None:
        opts = self.opts
        long_idx = [i for i, d in enumerate(unit) if len(d.seq) > opts.max_read_len]
        enc = self._encode_unit(unit)

        with trace.span("unit.step") as step:
            out = self._device_step(enc.codes, enc.ambig, enc.lengths)
            n = len(unit)
            dc = self.dev_counters
            # a unit's short and long lanes must meet in ONE unit-local counter
            # per taxon for the sparse-regime decision, so a unit with long
            # reads under sparse tracking folds entirely on the host (merged at
            # finalized_counts)
            use_dev = dc is not None and not (long_idx and dc.tracker is not None)
            uid = self.uid_map is not None
            if use_dev:
                # per-taxon accumulation stays on the device; the long reads'
                # zero-length placeholder rows are not counted (their lanes fold
                # on the host below). Under UID the k-mers count under the raw
                # ids and no read on the device (the calls resolve on the host)
                row_valid = torch.zeros(out["call_dense"].shape[0], dtype=torch.bool, device=self.device)
                if uid:
                    dc.update(out["taxa"], out["enc"], out["hll_lanes"], torch.zeros_like(out["call_dense"]),
                              row_valid)
                else:
                    row_valid[:n] = True
                    row_valid[long_idx] = False
                    dc.update(out["taxa_dense"], out["enc"], out["hll_lanes"], out["call_dense"], row_valid)
            taxa = out["taxa"].cpu().numpy().view(np.uint32)
            ambig = out["ambig"].cpu().numpy()
            calls = out["call"][:n].cpu().numpy().view(np.uint32).copy()
            hits = out["hits"][:n].cpu().numpy().astype(np.int64)
            n_kmers = out["n_kmers"][:n].cpu().numpy().astype(np.int64)
            calls = self._resolve_uid_calls(taxa, n_kmers, calls, n)
            if not use_dev or opts.exact:
                hll_lanes = out["hll_lanes"].cpu().numpy()
                # the k-mer stream the host folds: canonical k-mers or encodings
                kmers = (out["canon"].cpu().numpy().view(np.uint64) if opts.exact
                         else out["enc"].cpu().numpy().view(np.uint32))
            long_results = {}
            for i in long_idx:
                res = long_results[i] = self._classify_long_read(unit[i].seq)
                calls[i], hits[i] = res[3], res[4]
        if not self._is_root:
            return None

        def long_lanes(i):
            t_l, a_l, e_l, _, _, proc, c_l = long_results[i]
            lanes = proc & ~a_l
            return t_l[lanes], (c_l if opts.exact else e_l)[lanes]

        if use_dev:
            if uid:  # the read counts key on the resolved taxids, long reads' too
                self.counter.process_unit(_EMPTY, _EMPTY, calls)
            if opts.exact:
                # the device holds the counters; the sets fold on the host
                # (the placeholder rows hold no counted lane)
                lanes = hll_lanes[:n]
                self.counter.process_sets(taxa[:n][lanes], kmers[:n][lanes])
            for i in long_idx:
                self.counter.process_unit(*long_lanes(i), _EMPTY if uid else np.asarray([calls[i]], dtype=np.uint32))
        else:
            # per-taxon accumulation in read order (work-unit HLL semantics:
            # a counter at the sparse threshold goes by stream order), the
            # short reads between long ones a block of rows each
            parts, start = [], 0
            for i in [*long_idx, n]:
                lanes = hll_lanes[start:i]
                parts.append((taxa[start:i][lanes], kmers[start:i][lanes]))
                if i < n:
                    parts.append(long_lanes(i))
                start = i + 1
            self.counter.process_unit(np.concatenate([t for t, _ in parts]),
                                      np.concatenate([e for _, e in parts]), calls)

        for i, dna in enumerate(unit):
            call = int(calls[i])
            self.total_classified += call != 0
            if unclassified_fh is not None and not call:
                unclassified_fh.write(format_sequence(dna, fastq))
            if classified_fh is not None and call:
                classified_fh.write(format_sequence(dna, fastq))
            if kraken_fh is not None:
                if not call and opts.only_classified_output:
                    continue
                if i in long_results:
                    row_t, row_a = long_results[i][0], long_results[i][1]
                else:
                    nk = int(n_kmers[i])
                    row_t, row_a = taxa[i, :nk], ambig[i, :nk]
                kraken_fh.write(
                    kraken_line(
                        dna.id,
                        call,
                        len(dna.seq),
                        row_t,
                        row_a,
                        quick=opts.quick,
                        hits=int(hits[i]),
                        sequence=dna.seq if opts.print_sequence else None,
                    )
                )
        self.total_sequences += n
        self.total_bases += sum(len(d.seq) for d in unit)
        self.n_units += 1
        self.n_long_reads += len(long_idx)
        return step

    # ------------------------------------------------------------ span route

    def _iter_native_spans(self, path):
        """Parse the input in _CHUNK_BYTES byte chunks (kuniq_native_torch.
        parse_unit) and cut it into work units and spans, in read order:
        ("span", buf, offs, unit_bounds, fastq), or ("fallback", records,
        None, unit_bounds, fastq) for a chunk that needs Python records
        (multi-line FASTA, an overlong read).

        A work unit never ends at a chunk boundary: the records of a chunk's
        unfinished last unit (and its last record, which may be cut) start
        the next chunk. So units fall as in one pass over the file
        (classify.cpp:511-521), and both routes give the same HLL estimates.
        The JAX package's span route restarts its units at every 32 MB chunk
        instead (its _native_chunks / _iter_native_spans)."""
        from .._native_build import native

        nat = native()
        fastq = is_fastq(path)
        with open_maybe_compressed(path, "rb") as fh:
            carry, eof = b"", False
            while not eof:
                # a "parse" span a chunk: the read, parse_unit and the cut
                # into units and spans, which are yielded after it closes
                with trace.span("parse"):
                    chunk = fh.read(_CHUNK_BYTES)
                    eof = not chunk
                    buf, carry = carry + chunk, b""
                    if not buf:
                        break
                    items, carry = self._cut_chunk(nat, buf, eof, fastq)
                yield from items

    def _cut_chunk(self, nat, buf: bytes, eof: bool, fastq: bool) -> tuple[list, bytes]:
        """One parsed chunk's spans (or its fallback) as _iter_native_spans
        yields them, and the bytes that start the next chunk."""
        n, offs, multi = nat.parse_unit(buf, fastq)
        cut = len(buf)  # where the bytes to carry start
        if not eof:
            if n <= 1:  # no record known to be complete yet
                return [], buf
            n -= 1  # the last record may be cut short
            cut = int(offs[n, 2]) - 1  # its '>' or '@'
            offs = offs[:n]
        if n == 0:
            return [], b""
        records = None
        if multi or bool((np.abs(offs[:, 5]) > self.opts.max_read_len).any()):
            text = buf[:cut].decode("ascii", "replace")
            reader = read_fastq(io.StringIO(text)) if fastq else read_fasta(io.StringIO(text))
            records = list(reader)[:n]
            seq_lens = [len(d.seq) for d in records]
        else:
            seq_lens = offs[:, 5].tolist()
        bounds = _unit_bounds(seq_lens, self.opts.work_unit_size)
        if bounds[-1] != n:
            if eof:
                bounds.append(n)
            else:  # an unfinished unit: its records start the next chunk
                cut = int(offs[bounds[-1], 2]) - 1
        carry = buf[cut:]
        if bounds[-1] == 0:
            return [], carry
        if records is not None:
            return [("fallback", records, None, bounds, fastq)], carry
        # consecutive units grouped into spans of at most SPAN_READS reads
        # and MAX_UNITS units (the sparse-exact keys' unit field, which the
        # span counters of item 4 use)
        span_reads = self.opts.device_batch_reads or SPAN_READS
        items = []
        i = 0
        while i < len(bounds) - 1:
            j = i + 1
            while j < len(bounds) - 1 and bounds[j + 1] - bounds[i] <= span_reads and j - i < MAX_UNITS:
                j += 1
            items.append(("span", buf, offs[bounds[i] : bounds[j]], [b - bounds[i] for b in bounds[i : j + 1]],
                          fastq))
            i = j
        return items, carry

    def _python_fallback_chunk(self, records, unit_bounds, fastq, kraken_fh, classified_fh,
                               unclassified_fh) -> None:
        """The chunk's whole work units (records[unit_bounds[i]:
        unit_bounds[i + 1]]) through the Python route (multi-line FASTA,
        overlong reads)."""
        for s_, e_ in zip(unit_bounds[:-1], unit_bounds[1:]):
            self._process_unit(records[s_:e_], fastq, kraken_fh, classified_fh, unclassified_fh)
        self._progress()

    def _run_native(self, path, kraken_fh, classified_fh, unclassified_fh) -> None:
        # The JAX package first warms its device link (_warm_link) against a
        # TPU transport's first-transfer ramp; a card's copy engines have no
        # such ramp, so the port starts with the first span.
        pending = deque()  # (global index, span) in flight, in read order
        outs = (kraken_fh, classified_fh, unclassified_fh)

        def finish():
            idx, st = pending.popleft()
            with self._manifest_span(idx, kraken_fh):
                self._finish_native_span(st, *outs)

        for kind, buf, offs, unit_bounds, fastq in self._iter_native_spans(path):
            idx = self._claim_span()
            if idx is None:
                continue
            if kind == "fallback":
                while pending:  # keep the output in read order
                    finish()
                with self._manifest_span(idx, kraken_fh):
                    self._python_fallback_chunk(buf, unit_bounds, fastq, *outs)
                continue
            pending.append((idx, self._start_native_span(buf, offs, unit_bounds, fastq, idx)))
            # the card runs the newest spans while the host finishes the oldest
            while len(pending) > PIPELINE_DEPTH:
                finish()
            self._progress()
        while pending:
            finish()
        self._progress()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device: through a pinned buffer without
        blocking the host on a card (the pinned block is not reused before
        the copy ends), as it is on the CPU."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _encode_span(self, buf, offs):
        """One span's packed feed (uint32 [B, LB/16] code words, [B, LB/32]
        flag words, int32 [B] lengths; padding ambiguous): rows padded to
        1024, 8192 or 65536 and LB to the Python route's length buckets."""
        from .._native_build import native

        lb = _bucket_len(max(int(np.max(offs[:, 5])), self.k), max(128, self.k))
        b = self._round_mesh(_bucket(len(offs), 1024, step=8))
        return native().encode_unit_packed(buf, np.ascontiguousarray(offs), lb, b)

    def _span_feed(self, codes, ambig, lengths):
        """A span's feed on the device: encode_unit_packed's arrays are
        uploaded (as int32 words; under a mesh this rank's rows), device
        tensors pass as they are."""
        if isinstance(codes, torch.Tensor):
            return codes, ambig, lengths
        if self.mesh is not None:
            rows = self.mesh.rows(codes.shape[0])
            codes, ambig, lengths = (np.ascontiguousarray(a[rows]) for a in (codes, ambig, lengths))
        return self._upload(codes.view(np.int32)), self._upload(ambig.view(np.int32)), self._upload(lengths)

    def _span_step(self, codes, ambig, lengths, plain: bool = False, cfg: StepConfig | None = None,
                   planes=None):
        """The span step on encode_unit_packed's arrays (or their device
        copies); returns the device tensors of cfg.outputs (default: the
        span config's). `planes`: the resident tables (default) or, out of
        core, the span's merged word plane. `plain=True` runs every kernel's
        plain version (for holding the kernels against them)."""
        return classify_step_core(
            self._db_planes if planes is None else planes,
            self._taxid_table,
            self._io,
            self._parent,
            self._root_dense,
            *self._span_feed(codes, ambig, lengths),
            cfg or self._cfg_packed,
            plain=plain,
            mesh=self.mesh,
        )

    def _mesh_step(self, st: dict, cfg: StepConfig | None = None):
        """A span's step on a mesh: this rank's rows on its shards, the
        outputs gathered to rank 0 and there, for the span's own dispatch
        with device counters, the counters' update (JAX pipeline.py:
        657-663, 1473-1494). Returns (outputs on rank 0, None elsewhere;
        the sparse-stats buffer or ()). Every rank keeps the span
        dictionary ("lut"), whose count decides a redispatch."""
        cfg = cfg or self._cfg_packed
        counting = self.opts.device_counters and cfg is self._cfg_packed
        if counting:
            counted = (self._fb_id_key, "enc", "hll_lanes", "call_dense")
            cfg = dataclasses.replace(cfg, outputs=cfg.outputs + tuple(k for k in counted if k not in cfg.outputs))
        out = self._span_step(*st["feed"], cfg=cfg, planes=st["acc"])
        st["lut"] = out.get("lut")
        out = self.mesh.gather_rows(out, st["b"])
        sp = ()
        if counting and out is not None:
            from .device_counters import update_core

            dc, b = self.dev_counters, st["b"]
            n_valid = 0 if self.uid_map is not None else st["n_span"]
            row_valid = torch.arange(b, device=self.device) < n_valid
            sp = update_core(
                *dc.state(), dc.lut, out[self._fb_id_key], out["enc"], out["hll_lanes"], out["call_dense"],
                row_valid, dc.p, self._upload(self._unit_id_rows(st["unit_bounds"], b)), dc.sparse_cap,
                dc.counts_only,
            )[3:]
        return out, sp

    def _span_count_step(self, codes, ambig, lengths, n_span: int, unit_bounds, plain: bool = False,
                         planes=None):
        """The span step with the device counters' update on the same
        stream (classify_and_count_core): returns the span config's outputs
        and the sparse-stats buffer (() when not tracked). `planes` as in
        _span_step."""
        dc = self.dev_counters
        return classify_and_count_core(
            *dc.state(),
            dc.lut,
            self._db_planes if planes is None else planes,
            self._taxid_table,
            self._io,
            self._parent,
            self._root_dense,
            *self._span_feed(codes, ambig, lengths),
            # UID: no read count on the device (the calls are resolved on the
            # host, JAX pipeline.py:1367)
            0 if self.uid_map is not None else n_span,
            self._upload(self._unit_id_rows(unit_bounds, codes.shape[0])),
            self._cfg_packed,
            dc.p,
            dc.sparse_cap,
            dc.counts_only,
            plain=plain,
        )

    @staticmethod
    def _unit_id_rows(unit_bounds, b: int) -> np.ndarray:
        """Per-row work-unit index (uint8 [b]); padded rows inherit the last
        unit (they hold no counted lanes)."""
        ub = np.asarray(unit_bounds, np.int64)
        ids = np.repeat(np.arange(len(ub) - 1, dtype=np.uint8), np.diff(ub))
        last = ids[-1] if len(ids) else np.uint8(0)
        return np.concatenate([ids, np.full(b - len(ids), last, np.uint8)])

    @contextlib.contextmanager
    def _stage(self, stage: str, **ids):
        """The span "span.<stage>" of a span route's host stage, charged on
        its close."""
        with trace.span("span." + stage, **ids) as sp:
            yield sp
        self._charge(stage, sp)

    def _charge(self, stage: str, sp: trace.Span) -> None:
        """A finished span's self time to span_host_seconds[stage] and
        host_seconds."""
        self.span_host_seconds[stage] += sp.self_seconds
        self.host_seconds += sp.self_seconds

    def _start_native_span(self, buf, offs, unit_bounds, fastq, idx: int):
        """Encode global span idx, launch its step (with the counters'
        update) and start its fetch; returns the state _finish_native_span
        reads."""
        return self._dispatch_span(self._encode_native_span(buf, offs, unit_bounds, fastq, idx))

    def _encode_native_span(self, buf, offs, unit_bounds, fastq, idx: int) -> dict:
        """A span's host state and its packed feed (host arrays, "feed")."""
        with self._stage("encode", span=idx):
            offs = np.ascontiguousarray(offs)
            st = {
                "idx": idx, "buf": buf, "offs": offs, "unit_bounds": unit_bounds, "fastq": fastq,
                "seq_lens": np.ascontiguousarray(offs[:, 5], dtype=np.int32), "n_span": len(offs),
                "feed": self._encode_span(buf, offs), "acc": None,
            }
            st["b"] = st["feed"][0].shape[0]
        return st

    def _dispatch_span(self, st: dict) -> dict:
        """Launch a span's step (with the counters' update; out of core on
        its merged word plane) and start its fetch; returns the state
        _finish_native_span reads. On the CPU the step itself runs in a
        "span.step.cpu" child span: the device's time, not the host's."""
        with self._stage("step", span=st["idx"]):
            n_span, unit_bounds, feed = st["n_span"], st["unit_bounds"], st["feed"]
            cuda = self.device.type == "cuda"
            step_evs = None
            if cuda:
                step_evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                step_evs[0].record()
            with contextlib.nullcontext() if cuda else trace.span("span.step.cpu") as on_cpu:
                sp = ()
                if self.mesh is not None:
                    out, sp = self._mesh_step(st)
                elif self.dev_counters is not None:
                    out, sp = self._span_count_step(*feed, n_span, unit_bounds, planes=st["acc"])
                else:
                    out = self._span_step(*feed, planes=st["acc"])
            if cuda:
                step_evs[1].record()
            else:
                self.device_seconds += on_cpu.seconds
            if out is None:  # a mesh rank other than 0: nothing to fetch
                st.update(out=None, host=None, fetch_evs=None, step_evs=step_evs, sp=None)
                return st
            host, fetch_evs = self._slice_and_prefetch(out, st["b"], n_span)
            sp_pending = self.dev_counters.start_sp(sp, self._fetch_stream) if sp else None
        # `out` stays referenced until the finish has waited for the fetch:
        # the copies read it on the fetch stream. The feed (and out of core
        # the word plane) stays for a redispatch (a dictionary or
        # sparse-buffer overflow).
        st.update(out=out, host=host, fetch_evs=fetch_evs, step_evs=step_evs, sp=sp_pending)
        return st

    # ------------------------------------------------------- out-of-core route

    def _start_ooc_span(self, buf, offs, unit_bounds, fastq, idx: int) -> dict:
        """Encode global span idx and put its feed on the device for its
        group; the chunk passes and the finish step run when the group is
        flushed. "bytes" counts what the span holds on the device until its
        finish: the packed codes and flags, the lengths and the int32 [B, W]
        word plane."""
        st = self._encode_native_span(buf, offs, unit_bounds, fastq, idx)
        with self._stage("step", span=idx):
            st["feed"] = codes, ambig, lengths = self._span_feed(*st["feed"])
            w = 16 * codes.shape[1] - self.k + 1
            st["bytes"] = sum(a.numel() * a.element_size() for a in st["feed"]) + 4 * codes.shape[0] * w
        return st

    def _ooc_probe_group(self, spans: list, plain: bool = False) -> trace.Span:
        """Stream every chunk table through the card once for a group of
        spans (each with its packed feed): the outer chunk loop of
        classify.cpp:587-648, with the reference's on-disk hit merge
        replaced by each span's device word plane, which this allocates
        ("acc") and fills. Chunks go in database order, so the first
        database's hit wins; a chunk pass probes only the lanes whose
        minimizer bin (the database's own nt) lies in the chunk's range.
        Double-buffered, chunk i + 1's copy is started before chunk i's
        probes are launched, into the other slot; single-buffered, each copy
        waits for the previous chunk's probes. Under a mesh the chunks go in
        groups of n_db (JAX pipeline.py:879-977): this rank streams chunk
        g * n_db + db_j of each database's group g, and the group's words
        merge over the db group in the pass (probe_chunk_core).
        Returns its "ooc.group" span."""
        with trace.span("ooc.group", group=self.ooc_groups) as sp:
            for st in spans:
                if st["acc"] is None:
                    codes = st["feed"][0]
                    w = 16 * codes.shape[1] - self.k + 1
                    st["acc"] = torch.zeros((codes.shape[0], w), dtype=torch.int32, device=self.device)
            slots = self._ooc_slots
            n_slots = 2 if self._ooc_prefetch else 1
            n_g, j = (1, 0) if self.mesh is None else (self.mesh.n_db, self.mesh.db_j)
            seq = [(cdb, ci) for cdb in self._ooc for ci in range(j, cdb.n_chunks, n_g)]
            evs = self._ooc_events if self.device.type == "cuda" else None
            if evs is not None:
                self._ooc_fold(wait=False)
                group_evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                group_evs[0].record()
            for i, (cdb, ci) in enumerate(seq):
                s = i % n_slots
                slots.load(s, cdb, ci, None if evs is None else evs["upload"])
                if self._ooc_prefetch and i + 1 < len(seq):
                    slots.load((i + 1) % n_slots, *seq[i + 1], None if evs is None else evs["upload"])
                planes = slots.planes(s, cdb, ci)
                if evs is not None:
                    probe_evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    probe_evs[0].record()
                for st in spans:
                    probe_chunk_core(st["acc"], planes, cdb.bounds[ci], *st["feed"], self.k, cdb.nt, plain=plain,
                                     mesh=self.mesh)
                if evs is not None:
                    probe_evs[1].record()
                    evs["probe"].append(probe_evs)
                slots.release(s)
            if evs is not None:
                group_evs[1].record()
                evs["group"].append(group_evs)
            self.ooc_groups += 1
        return sp

    def _ooc_fold(self, wait: bool) -> None:
        """Turn the recorded chunk-pass events into milliseconds
        (ooc_times): those the card has passed, or all of them with `wait`."""
        for kind, pending in self._ooc_events.items():
            keep = []
            for ev in pending:
                if wait or ev[1].query():
                    ev[1].synchronize()
                    self.ooc_times[kind].append(ev[0].elapsed_time(ev[1]))
                else:
                    keep.append(ev)
            pending[:] = keep

    def ooc_timings(self) -> dict:
        """Milliseconds of the run's chunk copies ("upload", per copy), chunk
        passes ("probe", each chunk's probes of a group) and group passes
        ("group", from the first copy's wait to the last probe), from CUDA
        events (empty on the CPU)."""
        self._ooc_fold(wait=True)
        return {kind: list(ms) for kind, ms in self.ooc_times.items()}

    def _run_native_ooc(self, path, kraken_fh, classified_fh, unclassified_fh) -> None:
        """The span route out of core: spans gather into a group until their
        device bytes reach ooc_group_bytes; then every chunk table makes one
        pass through the card for the whole group and the group's spans are
        finished in read order (PIPELINE_DEPTH in flight)."""
        outs = (kraken_fh, classified_fh, unclassified_fh)
        group: deque = deque()  # (global index, span)
        group_bytes = 0

        def finish(item):
            idx, st = item
            with self._manifest_span(idx, kraken_fh):
                self._finish_native_span(st, *outs)

        def flush():
            nonlocal group_bytes
            if not group:
                return
            self._charge("probe", self._ooc_probe_group([st for _, st in group]))
            pending = deque()
            while group:
                idx, st = group.popleft()
                pending.append((idx, self._dispatch_span(st)))
                while len(pending) > PIPELINE_DEPTH:
                    finish(pending.popleft())
            while pending:
                finish(pending.popleft())
            group_bytes = 0
            self._progress()

        for kind, buf, offs, unit_bounds, fastq in self._iter_native_spans(path):
            idx = self._claim_span()
            if idx is None:
                continue
            if kind == "fallback":
                flush()  # keep the output in read order
                with self._manifest_span(idx, kraken_fh):
                    self._python_fallback_chunk(buf, unit_bounds, fastq, *outs)
                continue
            st = self._start_ooc_span(buf, offs, unit_bounds, fastq, idx)
            group.append((idx, st))
            group_bytes += st["bytes"]
            if group_bytes >= self.opts.ooc_group_bytes:
                flush()
        flush()
        self._progress()

    def _slice_and_prefetch(self, out: dict, b: int, n_span: int):
        """Start the copies of what the host reads: the RLE rows and the HLL
        feed down to an 8192-row grid (a tail span's padded rows are not
        fetched) and the span dictionary. On a card the copies go on the
        fetch stream, after the step, into pinned buffers, and do not block
        the host; returns the host tensors and the (start, end) events of
        the copies (None on the CPU)."""
        rows = min(b, -(-n_span // _FETCH_GRID) * _FETCH_GRID)
        src = {key: out[key][:rows] for key in self._span_fetch if key in out}
        if "lut" in out:
            src["lut"] = out["lut"]
        if self.device.type != "cuda":
            return src, None
        stream = self._fetch_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        host = {}
        with torch.cuda.stream(stream):
            evs[0].record(stream)
            for key, t in src.items():
                host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host[key].copy_(t, non_blocking=True)
            evs[1].record(stream)
        return host, evs

    @staticmethod
    def _exact_planes(host: dict, n_span: int):
        """The exact fold's fetched planes of a span's reads: taxids (u32),
        counted lanes (bool) and canonical k-mers (u64), each [n_span, W]."""
        return (host["taxa"].numpy().view(np.uint32)[:n_span], host["hll_lanes"].numpy()[:n_span],
                host["canon"].numpy().view(np.uint64)[:n_span])

    def _finish_native_span(self, st, kraken_fh, classified_fh, unclassified_fh) -> None:
        """Wait for one span's fetch, fold its HLL feed per work unit (or,
        with device counters, its sparse-stats buffer; with exact, its
        canonical k-mers) and write its kraken lines (overflow rows from the
        device planes). A span past the dictionary's capacity is run again
        on the wide rows first. A mesh rank other than 0 takes only the
        redispatches (_follow_span). The rows' decode is charged to the
        first stage after the wait: the UID resolve, else the fold."""
        if not self._is_root:
            self._follow_span(st)
            return
        idx = st["idx"]
        if st["fetch_evs"] is not None:
            with trace.span("span.fetch_wait", span=idx):
                st["fetch_evs"][1].synchronize()
            self.device_seconds += st["step_evs"][0].elapsed_time(st["step_evs"][1]) / 1e3
            self.fetch_seconds += st["fetch_evs"][0].elapsed_time(st["fetch_evs"][1]) / 1e3
        uid = self.uid_map is not None
        fold = "counters" if self.dev_counters is not None else "fold"
        with self._stage("uid" if uid else fold, span=idx):
            self._span_rows(st)
            if uid:
                st["calls"] = self._resolve_uid_calls(st["host"]["taxa"].numpy().view(np.uint32), st["n_kmers"],
                                                      st["calls"], st["n_span"])
            else:
                self._fold_span(st)
        if uid:
            with self._stage(fold, span=idx):
                self._fold_span(st)
        with self._stage("format", span=idx):
            self._format_span(st, kraken_fh, classified_fh, unclassified_fh)

    def _redispatch(self, st: dict, cfg: StepConfig) -> dict:
        """A span's step again under `cfg` (a dictionary or sparse-buffer
        overflow); under a mesh every rank takes it."""
        if self.mesh is None:
            return self._span_step(*st["feed"], cfg=cfg, planes=st["acc"])
        return self._mesh_step(st, cfg)[0]

    def _span_rows(self, st: dict) -> None:
        """Decode a fetched span's rows into st: "cfg" (the wide rows' after
        a dictionary overflow, whose redispatch replaces "out" and "host"),
        "id_map", "packed", "calls", "n_kmers" and "n_runs"."""
        n_span, seq_lens = st["n_span"], st["seq_lens"]
        out, host = st["out"], st["host"]
        cfg = self._cfg_packed
        id_map = self._taxids_host  # u16 dense (or local) ids -> taxids
        if cfg.local_dict:
            lut = host["lut"].numpy()
            n_u = int(lut[-1])
            if n_u > cfg.dict_capacity:
                # more distinct taxa than the dictionary holds: the wide rows
                # (rare); the counters were updated by the first dispatch
                cfg = self._cfg_packed_wide
                out = self._redispatch(st, cfg)
                self.dict_overflows += 1
                host = {key: out[key][:n_span].cpu() for key in ("packed", "hll_pairs", *_EXACT_FETCH)
                        if key in out}
            else:
                id_map = self._taxids_host[lut[:n_u].astype(np.int64)]
        r = cfg.max_runs
        # compact row: runs(R) | call_dense<<16 | n_runs; quick (dense)
        # row: runs(R) | call | hits<<16 | n_runs; wide row: run_vals(R) |
        # lens2(R/2) | call | n_kmers | hits<<16 | n_runs
        packed = np.ascontiguousarray(host["packed"].numpy().view(np.uint32)[:n_span])
        if not cfg.dense_runs:
            meta = r + r // 2
            calls = packed[:, meta].copy()
            n_kmers = packed[:, meta + 1].astype(np.int32)
            n_runs = packed[:, meta + 2] & np.uint32(0xFFFF)
        else:
            if self.opts.quick:
                calls = packed[:, r].copy()
                n_runs = packed[:, r + 1] & np.uint32(0xFFFF)
            else:
                calls = id_map[(packed[:, r] >> np.uint32(16)).astype(np.int64)]
                n_runs = packed[:, r] & np.uint32(0xFFFF)
            n_kmers = np.maximum(seq_lens - (self.k - 1), 0).astype(np.int32)
        st.update(out=out, host=host, cfg=cfg, id_map=id_map, packed=packed, calls=calls, n_kmers=n_kmers,
                  n_runs=n_runs)

    def _fold_span(self, st: dict) -> None:
        """Fold a decoded span's counts: with device counters the sparse
        stats (and, with exact, the k-mer sets; under UID the read counts),
        else the HLL feed per work unit."""
        opts = self.opts
        n_span, bounds, calls, host, out, cfg = (st[key] for key in ("n_span", "unit_bounds", "calls", "host",
                                                                     "out", "cfg"))
        uid = self.uid_map is not None
        dc = self.dev_counters
        if dc is not None:
            # the counts and registers were updated in the step's stream;
            # the sparse-regime stats fold here
            fb_key = self._fb_id_key
            overflow = st["sp"] is not None and not dc.finish_sp(st["sp"])
            if self.mesh is not None:
                self.mesh.broadcast_flag(overflow)  # the other ranks redispatch with rank 0
            if overflow:
                fb = self._redispatch(st, self._cfg_sparse_fb)
                dc.consume_host(fb[fb_key][:n_span], fb["enc"][:n_span], fb["hll_lanes"][:n_span],
                                unit_bounds=bounds)
            if dc.host_stats:
                dc.consume_host(out[fb_key][:n_span], out["enc"][:n_span],
                                out["hll_lanes"][:n_span], unit_bounds=bounds)
            if opts.exact:
                # the counters are on the device (counts only); the sets fold
                # here from the canon plane, span-wide (a union needs no units)
                taxa_x, lanes_x, canon_x = self._exact_planes(host, n_span)
                self.counter.process_sets(taxa_x[lanes_x], canon_x[lanes_x])
            if uid:
                # the read counts key on the resolved taxids: the host counter
                self.counter.process_unit(_EMPTY, _EMPTY, calls)
        elif opts.exact:
            # per-unit fold of each counted lane's taxon and canonical k-mer
            taxa_x, lanes_x, canon_x = self._exact_planes(host, n_span)
            for s_, e_ in zip(bounds[:-1], bounds[1:]):
                ok = lanes_x[s_:e_]
                self.counter.process_unit(taxa_x[s_:e_][ok], canon_x[s_:e_][ok], calls[s_:e_])
        elif cfg.dense_runs:
            # per-unit HLL fold (work-unit semantics): u32 encodings and u16
            # ids (0xFFFF: lane not counted)
            id_map = st["id_map"]
            hd = host["hll_dense"].numpy().view(np.uint16)[:n_span]
            he = host["hll_enc"].numpy().view(np.uint32)[:n_span]
            for s_, e_ in zip(bounds[:-1], bounds[1:]):
                m = hd[s_:e_] != np.uint16(0xFFFF)
                self.counter.process_unit(id_map[hd[s_:e_][m].astype(np.int64)], he[s_:e_][m], calls[s_:e_])
        else:
            # the wide rows' u64 feed: dense id<<32 | encoding, all ones on
            # the lanes not counted (under UID the raw id, counted as it is)
            pairs = host["hll_pairs"].numpy().view(np.uint64)
            for s_, e_ in zip(bounds[:-1], bounds[1:]):
                flat = pairs[s_:e_].reshape(-1)
                flat = flat[flat != np.uint64(0xFFFFFFFFFFFFFFFF)]
                taxa = (flat >> np.uint64(32)).astype(np.uint32)
                if not uid:
                    taxa = self._taxids_host[taxa.astype(np.int64)]
                self.counter.process_unit(taxa, (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                          calls[s_:e_])

    def _format_span(self, st: dict, kraken_fh, classified_fh, unclassified_fh) -> None:
        """Write a decoded span's kraken lines (overflow rows from the
        device planes) and reads, and count it."""
        from .._native_build import native

        nat = native()
        opts = self.opts
        buf, offs_c, seq_lens, n_span = st["buf"], st["offs"], st["seq_lens"], st["n_span"]
        out, cfg, packed, calls, n_kmers, n_runs = (st[key] for key in ("out", "cfg", "packed", "calls", "n_kmers",
                                                                        "n_runs"))
        r = cfg.max_runs
        if kraken_fh is not None:
            # rows with more runs than R: their planes gathered on the device,
            # mapped and formatted on the host
            ov_rows = np.empty(0, dtype=np.int64) if opts.quick else np.flatnonzero(n_runs > r)
            ov_lines = []
            if len(ov_rows):
                idx = torch.from_numpy(ov_rows).to(self.device)
                if "taxa" in out:  # the exact step's taxids plane
                    taxa_rows = out["taxa"][idx].cpu().numpy().view(np.uint32)
                else:
                    taxa_rows = self._taxids_host[out["taxa_dense"][idx].cpu().numpy().astype(np.int64)]
                ambig_rows = out["ambig"][idx].cpu().numpy().astype(np.uint8)
                sub = nat.kraken_lines(
                    buf,
                    np.ascontiguousarray(offs_c[ov_rows, 0]),
                    np.ascontiguousarray(offs_c[ov_rows, 1]),
                    np.ascontiguousarray(calls[ov_rows], dtype=np.uint32),
                    np.ascontiguousarray(seq_lens[ov_rows]),
                    np.ascontiguousarray(n_kmers[ov_rows]),
                    np.ascontiguousarray(taxa_rows),
                    np.ascontiguousarray(ambig_rows),
                    False,
                    np.ascontiguousarray(n_kmers[ov_rows]),  # hits: unused (not quick)
                    False,
                )
                ov_lines = sub.splitlines(keepends=True)
                if len(ov_lines) != len(ov_rows):
                    raise RuntimeError("kraken_lines: one line per overflow row expected")
            if self.uid_map is not None:  # the rows' call word: the resolved calls
                packed = packed.copy()
                packed[:, r + r // 2] = calls
            lines = nat.kraken_lines_rle(
                buf,
                np.ascontiguousarray(offs_c[:, 0]),
                np.ascontiguousarray(offs_c[:, 1]),
                packed,
                r,
                seq_lens,
                bool(opts.quick),
                bool(opts.only_classified_output),
                ov_rows.astype(np.int64),
                ov_lines,
                cfg.dense_runs,
                self.k,
                st["id_map"] if cfg.dense_runs else None,
            )
            if hasattr(kraken_fh, "buffer"):
                kraken_fh.flush()  # text written through the wrapper goes first
                kraken_fh.buffer.write(lines)
            else:
                try:
                    kraken_fh.write(lines)
                except TypeError:
                    kraken_fh.write(lines.decode())

        if classified_fh is not None or unclassified_fh is not None:
            for i in range(n_span):
                fh = classified_fh if calls[i] else unclassified_fh
                if fh is None:
                    continue
                o = offs_c[i]
                hdr = buf[o[2] : o[2] + o[3]].decode()
                seq = buf[o[4] : o[4] + o[5]].decode()
                if st["fastq"]:
                    quals = buf[o[6] : o[6] + o[7]].decode()
                    fh.write(f"@{hdr}\n{seq}\n+\n{quals}\n")
                else:
                    fh.write(f">{hdr}\n{seq}\n")

        self.total_classified += int(np.count_nonzero(calls))
        self.total_sequences += n_span
        self.total_bases += int(seq_lens.sum())
        self.n_spans += 1

    def _follow_span(self, st) -> None:
        """A mesh rank other than 0 at a span's finish: the steps rank 0
        takes again, in its order, on this rank's rows (a span past the
        dictionary's capacity, whose count every rank holds; a sparse-buffer
        overflow, which rank 0 broadcasts). The span's step time (CUDA
        events) and count are the rank's own."""
        if st["step_evs"] is not None:
            st["step_evs"][1].synchronize()
            self.device_seconds += st["step_evs"][0].elapsed_time(st["step_evs"][1]) / 1e3
        self.n_spans += 1
        cfg = self._cfg_packed
        if cfg.local_dict and int(st["lut"][-1]) > cfg.dict_capacity:
            self._mesh_step(st, self._cfg_packed_wide)
        if self.opts.device_counters and self.mesh.broadcast_flag(None):
            self._mesh_step(st, self._cfg_sparse_fb)

    # --------------------------------------------------------------- reports

    def report_stats(self, fh=None) -> None:
        """The run's totals, on `fh` (the sys.stderr of the call's moment
        by default); the seconds are the last run's "run" span."""
        fh = sys.stderr if fh is None else fh
        seconds = getattr(self, "_elapsed", 0.0) or 1e-9
        fh.write("\r")
        fh.write(
            "%d sequences (%.2f Mbp) processed in %.3fs (%.1f Kseq/m, %.2f Mbp/m).\n"
            % (
                self.total_sequences,
                self.total_bases / 1.0e6,
                seconds,
                self.total_sequences / 1.0e3 / (seconds / 60),
                self.total_bases / 1.0e6 / (seconds / 60),
            )
        )
        n = max(self.total_sequences, 1)
        fh.write(
            "  %d sequences classified (%.2f%%)\n"
            % (self.total_classified, self.total_classified * 100.0 / n)
        )
        fh.write(
            "  %d sequences unclassified (%.2f%%)\n"
            % (
                self.total_sequences - self.total_classified,
                (self.total_sequences - self.total_classified) * 100.0 / n,
            )
        )

    def ensure_counts_files(self) -> None:
        """Generate <db>.kdb.counts once per DB and feed genome sizes into the
        taxonomy (classify.cpp:260-285)."""
        for i, d in enumerate(self.db_dirs):
            path = os.path.join(d, "database.kdb") + ".counts"
            if not (os.path.exists(path) and os.path.getsize(path) > 0):
                vd = self._vals_dense(i)  # None: out-of-core UID tables
                hist = np.bincount(vd if vd is not None else [0], minlength=self.taxonomy.size)
                active = np.flatnonzero(hist)
                counts = {int(self.taxonomy.taxids[a]): int(hist[a]) for a in active}
                # values whose taxid was missing from the taxonomy land on
                # dense 0 with vals != 0 (a UID database's dense values are
                # all 0); fall back to the host histogram of database.kdb
                if vd is None or (vd == 0).any() and 0 in counts:
                    _, _, vals = read_kdb(os.path.join(d, "database.kdb"))
                    counts = counts_from_vals(vals)
                write_counts(path, counts)
            # feed each counts file into the taxonomy ONCE: set_genome_sizes
            # accumulates, so a second write_report would double every size
            fed = getattr(self.taxonomy, "_counts_fed", None)
            if fed is None:
                fed = self.taxonomy._counts_fed = set()
            key = os.path.abspath(path)
            if key not in fed:
                fed.add(key)
                self.taxonomy.set_genome_sizes(read_counts_stream_bugcompat(path))

    def finalized_counts(self) -> dict:
        """The final {taxid: ReadCounts} map, as fresh objects: the host
        fold's state merged with the device counters' (if any)."""
        counts = self.counter.counts
        if self.dev_counters is None:
            return {tid: rc.copy() for tid, rc in counts.items()}
        # UID counters key on the raw id itself (classify.cpp:939)
        dev_counts = self.dev_counters.finalize(
            np.arange(self.dev_counters.n_taxa, dtype=np.uint32) if self.uid_map is not None else self._taxids_host
        )
        # whatever folded on the host merges in; ReadCounts.iadd handles the
        # sparse-into-dense HLL merge
        for tid, rc in counts.items():
            if tid in dev_counts:
                dev_counts[tid].iadd(rc)
            else:
                dev_counts[tid] = rc.copy()
        return dev_counts

    def write_report(self, fh, extra_counts: list | None = None) -> None:
        """`extra_counts`: other hosts' finalized counts (dicts, or state
        files of parallel/multihost.save_counter_state) folded in first
        (JAX pipeline.py:2203-2215). Its "report" span holds TaxReport's
        "report.aggregate" and "report.write"."""
        with trace.span("report", run=trace.new_run()):
            self.ensure_counts_files()
            opts = self.opts
            counts = self.finalized_counts()  # fresh objects: the fold cannot touch the live state
            if extra_counts:
                from ..parallel.multihost import load_counter_state, merge_counts

                for other in extra_counts:
                    if isinstance(other, (str, os.PathLike)):
                        other = load_counter_state(os.fspath(other))
                    merge_counts(counts, other)
            rep = TaxReport(self.taxonomy, counts, show_zeros=opts.report_zeros)
            if opts.hll_precision > 0:
                rep.set_cols(FULL_COLS if opts.full_report else DEFAULT_COLS)
            else:
                rep.set_cols(NO_HLL_COLS)
            rep.write(fh)

    @staticmethod
    def spans() -> list[trace.Span]:
        """The process's finished spans (utils/trace.py's log): "load" with
        "load.taxonomy" and a "load.tables" a database; "run" with "parse",
        "span.<stage>", "span.fetch_wait", "ooc.group" (or, on the Python
        route, "unit" and "unit.step"); "report" with "report.aggregate" and
        "report.write"."""
        return trace.spans()
