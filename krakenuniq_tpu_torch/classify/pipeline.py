"""End-to-end classification driver on a torch device (Python host route).

Counterpart of krakenuniq_tpu/classify/pipeline.py for the resident,
single-device, CHD-hash path: reads stream in work units (greedy >=
500 kbp, the deterministic partition of classify.cpp:511-521); each
unit is padded into a bucketed (B, LB) batch, classified by one device step
(classify/device_step.py) and formatted and accumulated on the host in
Python. With `device_counters` the per-taxon counts and HLL registers
stay on the device (classify/device_counters.py) and the host fetches them
once, at the report. The native span parser, device RLE rows, long reads,
out-of-core tables and meshes of the JAX package are later slices.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..db import DeviceDB, load_database_dir
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
from ..report import DEFAULT_COLS, NO_HLL_COLS, TaxReport
from ..taxonomy import Taxonomy
from .accumulate import TaxonCounter
from .device_step import StepConfig, classify_step_core
from .output import kraken_line

WORK_UNIT_SIZE = 500_000  # bp, classify.cpp:38
# device batch width cap; longer reads need the long-read route, a later
# slice of the port
MAX_READ_LEN = 1 << 15
MIN_BATCH_READS = 64  # B is this times a power of two
# reference bug compatibility: -p never reaches an HLL constructor, every
# counter runs at precision 12 (hyperloglogplus.hpp:87, classify.cpp:289,
# 1094); the flag only gates the report's unique-k-mer columns
HLL_P = 12


@dataclasses.dataclass
class ClassifyOptions:
    quick: bool = False
    min_hits: int = 1
    hll_precision: int = 12  # 0 drops the report's unique-k-mer columns
    only_classified_output: bool = False
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
    value_pool: bool = True


def _bucket(n: int, lo: int) -> int:
    """Round a batch dimension up to lo times a power of two."""
    b = lo
    while b < n:
        b *= 2
    return b


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
                 _shared: "Classifier | None" = None):
        self.opts = options or ClassifyOptions()
        self.device = resolve_device(self.opts.device)
        self.db_dirs = [os.fspath(d) for d in db_dirs]
        if _shared is not None:
            self._adopt_loaded(_shared)
        else:
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
        if resolve_device(opts.device) != other.device:
            raise ValueError(f"cannot share {other.device} tables on {opts.device}")
        if opts.value_pool != other.opts.value_pool:
            raise ValueError("cannot share tables across value_pool settings")
        return cls(other.db_dirs, opts, _shared=other)

    def _adopt_loaded(self, other: "Classifier") -> None:
        for name in ("taxonomy", "dbs", "k", "nt", "_pool"):
            setattr(self, name, getattr(other, name))

    def _load(self) -> None:
        self.taxonomy = Taxonomy.from_taxdb_file(os.path.join(self.db_dirs[0], "taxDB"))
        pre_vd: dict[str, np.ndarray] = {}
        # value pool (db/pool.py): device ids index the databases'
        # LCA-closed value set when it fits u16, else dense taxonomy ids
        pool_arg = "auto" if self.opts.value_pool else None
        if len(self.db_dirs) > 1 and self.opts.value_pool:
            # hierarchical lookups merge into ONE taxon plane
            # (classify.cpp:927-936): every table speaks one joint id space
            for d in self.db_dirs:
                _, _, v = read_kdb(os.path.join(d, "database.kdb"))
                pre_vd[d] = compute_vals_dense(v, self.taxonomy)
            pool_arg = build_value_pool(list(pre_vd.values()), self.taxonomy)
        self.dbs: list[DeviceDB] = []
        for d in self.db_dirs:
            db, _ = load_database_dir(
                d, taxonomy=self.taxonomy, device=self.device, pool=pool_arg,
                vals_dense=pre_vd.pop(d, None),
            )
            self.dbs.append(db)
        ks = {db.k for db in self.dbs}
        if len(ks) != 1:
            raise ValueError(f"Different k-mer sizes in databases: {sorted(ks)}")
        nts = {db.nt for db in self.dbs}
        if len(nts) != 1:
            raise ValueError(f"Different minimizer sizes in databases: {sorted(nts)}")
        self.k = self.dbs[0].k
        self.nt = self.dbs[0].nt
        self._pool = self.dbs[0].pool

    def _configure(self) -> None:
        tax, pool = self.taxonomy, self._pool
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

        self._taxids_host = np.asarray(taxids, dtype=np.uint32)
        self._taxid_table = put(self._taxids_host.view(np.int32), np.int32)
        # the resolve's [T, 2] (tin, tout) table, gathered per k-mer lane
        self._io = put(np.stack([tin, tout], axis=1), np.int32)
        self._parent = put(parent, np.int32)
        self._db_planes = tuple(db.hash_table for db in self.dbs)
        self._cfg = StepConfig(
            k=self.k,
            max_depth=step_depth,
            hll_p=HLL_P,
            quick=self.opts.quick,
            min_hits=self.opts.min_hits,
        )
        # device-counters sparse tracking: ids past the device packing's
        # 2^TAXON_BITS taxon field fall back to HOST-computed per-unit stats
        # -- slower (three planes fetched) but still bit-exact
        from . import sparse_exact

        self._dc_host_stats = (
            self.opts.device_counters
            and self.opts.sparse_cap > 0
            and pool is None
            and tax.size >= (1 << sparse_exact.TAXON_BITS)
        )
        if self._dc_host_stats:
            print(
                "note: id space exceeds the device sparse-stats packing "
                f"(2^{sparse_exact.TAXON_BITS}); sparse-regime tracking runs on "
                "host (slower, still bit-exact)",
                file=sys.stderr,
            )
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero all accumulation state so the same loaded Classifier can run
        another input from scratch."""
        self._init_counters()
        self.total_sequences = 0
        self.total_bases = 0
        self.total_classified = 0
        # wall seconds of the device step (upload, kernels, fetch) and of the
        # host's share of each work unit (encode, accumulate, format)
        self.device_seconds = 0.0
        self.host_seconds = 0.0
        self.n_units = 0

    def _init_counters(self) -> None:
        self.counter = TaxonCounter(HLL_P)
        self.dev_counters = None
        if not self.opts.device_counters:
            return
        from .device_counters import DeviceCounters

        pool, tax = self._pool, self.taxonomy
        if pool is not None:
            # pool mode: the device id space IS the value closure --
            # registers and counters are pool-width and rows are ids
            self.dev_counters = DeviceCounters(
                pool.size, HLL_P, sparse_cap=self.opts.sparse_cap, device=self.device
            )
        else:
            # registers only ever accumulate under DB values: restrict the
            # plane to the value set so it scales with the database, not the
            # taxonomy (a 2.4M-node taxDB would otherwise cost 10 GB)
            reg_pool = np.unique(np.concatenate([np.unique(db.vals_dense) for db in self.dbs]))
            self.dev_counters = DeviceCounters(
                tax.size, HLL_P, pool_dense=reg_pool, sparse_cap=self.opts.sparse_cap,
                host_stats=self._dc_host_stats, device=self.device,
            )

    # ------------------------------------------------------------ unit input

    def _work_units(self, path: str):
        """Greedy >= WORK_UNIT_SIZE bp batches in read order (classify.cpp:511-521)."""
        fastq = is_fastq(path)
        with open_maybe_compressed(path, "rt") as fh:
            reader = read_fastq(fh) if fastq else read_fasta(fh)
            unit: list[DNASequence] = []
            total_nt = 0
            for dna in reader:
                unit.append(dna)
                total_nt += len(dna.seq)
                if total_nt >= WORK_UNIT_SIZE:
                    yield unit, fastq
                    unit, total_nt = [], 0
            if unit:
                yield unit, fastq

    # ------------------------------------------------------------- main loop

    def run(self, input_paths: list[str], kraken_fh=None, classified_fh=None,
            unclassified_fh=None) -> None:
        t0 = time.time()
        for path in input_paths:
            for unit, fastq in self._work_units(path):
                self._process_unit(unit, fastq, kraken_fh, classified_fh, unclassified_fh)
                self._progress()
        self._elapsed = time.time() - t0

    def _progress(self):
        if self.opts.print_progress:
            pct = 100.0 * self.total_classified / max(self.total_sequences, 1)
            sys.stderr.write(
                f"\r Processed {self.total_sequences} sequences ({pct:.2f}% classified)"
            )

    def _device_step(self, codes, ambig, lengths, plain: bool = False):
        """One classify step on numpy batch arrays; returns device tensors."""
        dev = self.device
        return classify_step_core(
            self._db_planes,
            self._taxid_table,
            self._io,
            self._parent,
            self._root_dense,
            torch.from_numpy(codes).to(dev),
            torch.from_numpy(ambig).to(dev),
            torch.from_numpy(lengths).to(dev),
            self._cfg,
            plain=plain,
        )

    def _encode_unit(self, unit):
        """Pad one work unit into its bucketed (B, LB) batch."""
        long_reads = [d.id for d in unit if len(d.seq) > MAX_READ_LEN]
        if long_reads:
            raise NotImplementedError(
                f"read {long_reads[0]!r} is longer than {MAX_READ_LEN} bases; "
                "the long-read route is a later slice of the port"
            )
        seqs = [d.seq for d in unit]
        max_len = max((len(s) for s in seqs), default=1)
        lb = _bucket_len(max(max_len, self.k), max(128, self.k))
        b = _bucket(len(unit), MIN_BATCH_READS)
        return encode_batch(seqs, lb=lb, batch=b)

    def _process_unit(self, unit, fastq, kraken_fh, classified_fh, unclassified_fh) -> None:
        opts = self.opts
        t_host0 = time.perf_counter()
        enc = self._encode_unit(unit)

        t_dev0 = time.perf_counter()
        out = self._device_step(enc.codes, enc.ambig, enc.lengths)
        n = len(unit)
        if self.dev_counters is not None:
            # per-taxon accumulation stays on the device; the encodings and
            # counted lanes are never fetched
            row_valid = torch.zeros(out["call_dense"].shape[0], dtype=torch.bool, device=self.device)
            row_valid[:n] = True
            self.dev_counters.update(
                out["taxa_dense"], out["enc"], out["hll_lanes"], out["call_dense"], row_valid
            )
        taxa = out["taxa"].cpu().numpy().view(np.uint32)
        ambig = out["ambig"].cpu().numpy()
        calls = out["call"][:n].cpu().numpy().view(np.uint32).copy()
        hits = out["hits"][:n].cpu().numpy().astype(np.int64)
        n_kmers = out["n_kmers"][:n].cpu().numpy().astype(np.int64)
        if self.dev_counters is None:
            enc_arr = out["enc"].cpu().numpy().view(np.uint32)
            hll_lanes = out["hll_lanes"].cpu().numpy()
        t_dev1 = time.perf_counter()

        if self.dev_counters is None:
            # per-taxon accumulation in read order (work-unit HLL semantics)
            lanes = hll_lanes[:n]
            self.counter.process_unit(taxa[:n][lanes], enc_arr[:n][lanes], calls)

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
                nk = int(n_kmers[i])
                kraken_fh.write(
                    kraken_line(
                        dna.id,
                        call,
                        len(dna.seq),
                        taxa[i, :nk],
                        ambig[i, :nk],
                        quick=opts.quick,
                        hits=int(hits[i]),
                    )
                )
        self.total_sequences += n
        self.total_bases += sum(len(d.seq) for d in unit)
        t_host1 = time.perf_counter()
        self.device_seconds += t_dev1 - t_dev0
        self.host_seconds += (t_host1 - t_host0) - (t_dev1 - t_dev0)
        self.n_units += 1

    # --------------------------------------------------------------- reports

    def report_stats(self, fh=sys.stderr) -> None:
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
                vd = self.dbs[i].vals_dense
                hist = np.bincount(vd, minlength=self.taxonomy.size)
                active = np.flatnonzero(hist)
                counts = {int(self.taxonomy.taxids[a]): int(hist[a]) for a in active}
                # values whose taxid was missing from the taxonomy land on
                # dense 0 with vals != 0; fall back to the host histogram
                if (vd == 0).any() and 0 in counts:
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
        dev_counts = self.dev_counters.finalize(self._taxids_host)
        # whatever folded on the host merges in; ReadCounts.iadd handles the
        # sparse-into-dense HLL merge
        for tid, rc in counts.items():
            if tid in dev_counts:
                dev_counts[tid].iadd(rc)
            else:
                dev_counts[tid] = rc.copy()
        return dev_counts

    def write_report(self, fh) -> None:
        self.ensure_counts_files()
        rep = TaxReport(self.taxonomy, self.finalized_counts())
        rep.set_cols(DEFAULT_COLS if self.opts.hll_precision > 0 else NO_HLL_COLS)
        rep.write(fh)
