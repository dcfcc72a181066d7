"""LCA database construction.

Reproduces -- byte-for-byte on the output files -- the reference build
pipeline's compute steps (scripts/build_db.sh steps 1-3 and 6):

  1. the k-mer *set* of the library (Jellyfish `count -C` equivalent:
     every canonical k-mer of every library sequence, non-ACGT windows
     skipped -- KmerScanner semantics, krakenutil.cpp:239-278),
  2. optional down-sampling to a maximum database size (db_shrink.cpp:80-113
     block sampling),
  3. minimizer binning + in-bin sort (db_sort.cpp:80-116: order is
     (scrambled-minimizer bin, k-mer)),
  6. the LCA fold over library sequences (set_lcas.cpp:429-476), including
     the contaminant-taxid override (`-T`, always passed by build_db.sh:271),
     `-E` minimum sequence size, the seqid->taxid resolution rules
     (exact map hit, `.N` numeric-suffix fallback, `kraken:taxid|` headers,
     set_lcas.cpp:290-323), and `--lca-order` priority rebuilds
     (reset + re-set passes, build_db.sh:279-301).

Unlike the reference (which streams sequences through a per-base scanner and
mutates a mmap'd file), everything here is vectorized per sequence: k-mers
are packed/canonicalized as whole numpy arrays and the LCA fold is applied
per unique (k-mer, sequence) pair. The fold itself is order-independent
(LCA is associative/commutative; the contaminant override is first-wins),
so per-sequence vectorization is exact.

Dynamic taxids (`-a`/`-A`: per-sequence / per-assembly pseudo-taxids above
1e9, set_lcas.cpp:182-266) are handled by `expand_dynamic_taxids`.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Iterable

import numpy as np

from ..formats.seqio import read_sequences
from ..utils.bits import bin_key, canonical_representation

TID_HUMAN = 9606
TID_MOUSE = 10090
# k-mers in contaminant sequences keep the contaminant taxid (set_lcas.cpp:88-89)
TID_CONTAMINANT1 = 32630  # 'synthetic construct'
TID_CONTAMINANT2 = 81077  # 'artificial sequences'
NEW_TAXID_START = 1_000_000_000
KRAKEN_PREFIX = "kraken:taxid|"

_CODE = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"AaCcGgTt", (0, 0, 1, 1, 2, 2, 3, 3)):
    _CODE[_b] = _c


def extract_canonical_kmers(seq: str | bytes, k: int) -> np.ndarray:
    """All valid canonical k-mers of a sequence, in scan order.

    KmerScanner semantics (krakenutil.cpp:239-278): lowercase acgt accepted,
    any other byte poisons every window containing it. Newlines never appear
    here (seqio strips them)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", "replace")
    buf = np.frombuffer(seq, dtype=np.uint8)
    n = len(buf)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    codes = _CODE[buf]
    ambig = codes == 255
    codes64 = np.where(ambig, 0, codes).astype(np.uint64)
    nk = n - k + 1
    km = np.zeros(nk, dtype=np.uint64)
    for j in range(k):
        km = (km << np.uint64(2)) | codes64[j : j + nk]
    if ambig.any():
        cs = np.concatenate([[0], np.cumsum(ambig)])
        valid = (cs[k:] - cs[:-k]) == 0
        km = km[valid]
    return canonical_representation(km, k)


def resolve_seq_taxid(seqid: str, seqmap: dict[str, int]) -> int:
    """Sequence-ID -> taxid resolution (set_lcas.cpp:290-323): exact map hit,
    then numeric `.N` version-suffix fallback, then `kraken:taxid|NNN|...`."""
    t = seqmap.get(seqid)
    if t is not None:
        return t
    pos = seqid.rfind(".")
    if pos != -1 and seqid[pos + 1 :].isdigit():
        t = seqmap.get(seqid[:pos])
        if t is not None:
            return t
    if seqid.startswith(KRAKEN_PREFIX):
        digits = ""
        for ch in seqid[len(KRAKEN_PREFIX) :]:
            if ch.isdigit():
                digits += ch
            else:
                break
        if digits:
            return int(digits)
    return 0


@dataclass
class BuildResult:
    keys: np.ndarray  # uint64, sorted by (scrambled-minimizer bin, k-mer)
    vals: np.ndarray  # uint32 LCA taxids
    offsets: np.ndarray  # uint64, len 4**nt + 1


# --------------------------------------------------------------------------
# Streaming pair-spill engine: build in BOUNDED MEMORY, as the reference
# streams 300 GB-class libraries through Jellyfish (build_db.sh:120-148)
# and OpenMP set_lcas (set_lcas.cpp:364-368); collecting every library
# k-mer into RAM would not scale to them.
#
# The streaming engine makes the whole build ONE reduction over a
# (k-mer, value) pair stream:
#
#   emit   -- stream the library once per pass (base + each --lca-order
#             group); per sequence block (k-1 overlap, the reference's
#             SKIP_LEN pattern) emit its distinct canonical k-mers paired
#             with a packed value word; spill pairs to 2^B on-disk buckets
#             partitioned by scrambled-minimizer-bin range, so buckets
#             concatenate in kdb order.
#   reduce -- per bucket: sort by (bin, k-mer, val); per k-mer segment the
#             packed-value order makes the fold semantics of
#             set_lcas.cpp:429-476 a pair of segment reductions:
#               * the max value's group byte selects the LAST --lca-order
#                 group containing the k-mer (reset+refold, build_db.sh:279-301),
#               * within that group, any contaminant pair wins and the
#                 EARLIEST one supplies the taxid (-T override, first-wins),
#               * otherwise LCA over the group's taxids = pairwise LCA of
#                 the two Euler-tin extremes (Taxonomy.lca_pairs).
#
# Value word layout (u64):
#   bits 56..63  pass group (0 = base; --lca-order groups are 1..255)
#   bit  55      contaminant claim
#   contaminant: bits 2..54 global sequence index (earliest-claim tie-break),
#                bits 0..1 contaminant code (1 = 32630, 2 = 81077)
#   otherwise:   bits 0..31 taxid (0 = set-only pair: the sequence failed a
#                set_lcas skip rule but its k-mers still belong to the key
#                set, build_db.sh step 1 cats the whole library)
# --------------------------------------------------------------------------

_GROUP_SHIFT = np.uint64(56)
_CONTAM_BIT = np.uint64(1) << np.uint64(55)
_SEQ_SHIFT = np.uint64(2)
# spill record: (k-mer, value word, scrambled-minimizer bin). The bin is a
# pure function of the k-mer but costs (k-nt+1) window passes to recompute
# (utils/bits.py bin_key) -- carrying the 8 bytes beats recomputing at
# reduce time by ~100x.
_PAIR_DTYPE = np.dtype([("k", "<u8"), ("v", "<u8"), ("b", "<u8")])
_SEQ_BLOCK = 1 << 22  # 4 Mbp sub-blocks bound per-sequence memory


def _extract_kmers_bins(seq: str, k: int, nt: int):
    """(canonical k-mers, bins) of one sequence block: the native rolling
    scanner (kuniq_native_torch.extract_kmer_bins), built at first use. A
    failed build raises: the plain version below never takes its place on
    the build's path."""
    from .._native_build import native
    from ..utils.bits import INDEX2_XOR_MASK

    raw = seq.encode("ascii", "replace")
    ks, bs, cnt = native().extract_kmer_bins(raw, k, nt, int(INDEX2_XOR_MASK))
    return ks[:cnt], bs[:cnt]


def _extract_kmers_bins_plain(seq: str, k: int, nt: int):
    """The scanner's plain version: the numpy shift cascade
    (extract_canonical_kmers) and the window minimum of bin_key."""
    ks = extract_canonical_kmers(seq, k)
    return ks, bin_key(ks, k, nt)


def _pack_val(group: int, taxid: int, is_contam: bool, seq_idx: int) -> np.uint64:
    g = np.uint64(group) << _GROUP_SHIFT
    if is_contam:
        code = 1 if taxid == TID_CONTAMINANT1 else 2
        return g | _CONTAM_BIT | (np.uint64(seq_idx) << _SEQ_SHIFT) | np.uint64(code)
    return g | np.uint64(taxid)


class _PairSpiller:
    """Partition (k-mer, val, bin) records into on-disk buckets by
    minimizer-bin range; buckets concatenate in the kdb's (bin, key) order.

    `boundaries` (sorted bin values, len n_buckets-1) define the ranges.
    Minimizer bins are MIN-biased -- a bin is the minimum over k-nt+1
    scrambled m-mer windows, so the low end of bin space carries most of
    the mass and equal-width ranges would put nearly everything in bucket 0
    (measured: 42M of 100M keys). The caller samples the library's own bin
    distribution for quantile boundaries -- the same adaptive-range idea as
    the reference's upper_bound chunk planner (krakendb.cpp:430-461)."""

    def __init__(
        self, k: int, nt: int, n_buckets: int, tmp_dir: str,
        boundaries: np.ndarray | None = None,
    ):
        self.k, self.nt = k, nt
        if boundaries is None:
            boundaries = np.empty(0, dtype=np.uint64)
            n_buckets = 1
        self.boundaries = np.asarray(boundaries, dtype=np.uint64)
        n_buckets = len(self.boundaries) + 1
        self.n_buckets = n_buckets
        self.tmp_dir = tmp_dir
        self.paths = [os.path.join(tmp_dir, f"pairs.{i:04d}.bin") for i in range(n_buckets)]
        self._fhs: list = [None] * n_buckets
        self._started = [False] * n_buckets  # truncate on first open only
        self._n_open = 0
        try:
            import resource
            soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
            if soft > 0:
                self._max_open = max(64, min(self._max_open, soft - 64))
        except Exception:
            pass
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self.flush_pairs = 4 << 20
        self.total_pairs = 0

    def add(self, kmers: np.ndarray, bins: np.ndarray, val: np.uint64) -> None:
        if not len(kmers):
            return
        rec = np.empty(len(kmers), dtype=_PAIR_DTYPE)
        rec["k"], rec["b"] = kmers, bins
        rec["v"] = val
        self._buf.append(rec)
        self._buffered += len(kmers)
        if self._buffered >= self.flush_pairs:
            self.flush()

    def flush(self) -> None:
        if not self._buffered:
            return
        rec = np.concatenate(self._buf)
        self._buf, self._buffered = [], 0
        self.total_pairs += len(rec)
        if self.n_buckets == 1:
            self._write(0, rec)
            return
        bucket = np.searchsorted(self.boundaries, rec["b"], side="right")
        order = np.argsort(bucket, kind="stable")
        bucket = bucket[order]
        rec = rec[order]
        bounds = np.searchsorted(bucket, np.arange(self.n_buckets + 1))
        for i in range(self.n_buckets):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                self._write(i, rec[lo:hi])

    # Keep well under the process's open-file limit: at reference scale a
    # flush touches essentially every bucket, and up to 4096 lazily-opened
    # handles would exceed the common `ulimit -n 1024`. Files are opened in
    # append mode so any handle can be dropped and reopened at will.
    _max_open = 512

    def _write(self, i: int, rec: np.ndarray) -> None:
        if self._fhs[i] is None:
            if self._n_open >= self._max_open:
                for j, fh in enumerate(self._fhs):
                    if fh is not None:
                        fh.close()
                        self._fhs[j] = None
                self._n_open = 0
            self._fhs[i] = open(self.paths[i], "ab" if self._started[i] else "wb")
            self._started[i] = True
            self._n_open += 1
        self._fhs[i].write(rec.tobytes())

    def close(self) -> None:
        self.flush()
        for fh in self._fhs:
            if fh is not None:
                fh.close()
        self._fhs = [None] * self.n_buckets
        self._n_open = 0

    def load_bucket(
        self, i: int, keys_only: bool = False
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not os.path.exists(self.paths[i]):
            e = np.empty(0, dtype=np.uint64)
            return e, e, e
        rec = np.fromfile(self.paths[i], dtype=_PAIR_DTYPE)
        if keys_only:  # counting passes skip materializing v/b columns
            e = np.empty(0, dtype=np.uint64)
            return rec["k"].copy(), e, e
        return rec["k"].copy(), rec["v"].copy(), rec["b"].copy()

    def cleanup(self) -> None:
        for p in self.paths:
            if os.path.exists(p):
                os.remove(p)


def _iter_seq_blocks(seq: str, k: int):
    """Sub-blocks with k-1 overlap (the reference's SKIP_LEN chunking,
    set_lcas.cpp:31,364-368) so one chromosome never owns gigabytes of
    pair buffer."""
    if len(seq) <= _SEQ_BLOCK:
        yield seq
        return
    step = _SEQ_BLOCK - (k - 1)
    for start in range(0, len(seq) - (k - 1), step):
        yield seq[start : start + _SEQ_BLOCK]


def _emit_pass(
    spiller: _PairSpiller,
    fastas: Iterable[str],
    seqmap: dict[str, int],
    known: set[int] | None,
    min_sequence_size: int,
    group: int,
    seq_idx0: int,
    k: int,
    set_only_unmapped: bool,
    verbose: bool,
) -> int:
    """Stream one library pass into the spiller; returns the next global
    sequence index. Base pass (group 0, set_only_unmapped=True) emits
    taxid-0 pairs for sequences that fail set_lcas skip rules -- their
    k-mers belong to the key set (build_db.sh step 1); --lca-order group
    passes skip those sequences entirely (set_lcas -TR / -T passes only see
    mapped sequences)."""
    seq_idx = seq_idx0
    for path in fastas:
        for dna in read_sequences(path):
            if not dna.seq:
                continue
            taxid = resolve_seq_taxid(dna.id, seqmap)
            skip = (
                taxid == 0
                or (min_sequence_size > 0 and len(dna.seq) < min_sequence_size)
                or (known is not None and taxid not in known)
            )
            if skip:
                if verbose and taxid == 0:
                    print(f"no taxid mapping for sequence {dna.id}", file=sys.stderr)
                if not set_only_unmapped:
                    continue
                taxid = 0
            is_contam = taxid in (TID_CONTAMINANT1, TID_CONTAMINANT2)
            val = _pack_val(group, taxid, is_contam, seq_idx)
            for block in _iter_seq_blocks(dna.seq, k):
                kms, bins = _extract_kmers_bins(block, k, spiller.nt)
                if len(kms):
                    # distinct within block: the fold is idempotent per
                    # (k-mer, value), so block-level dedup only cuts volume.
                    # Any occurrence's bin serves (bin is a k-mer function).
                    u, ui = np.unique(kms, return_index=True)
                    spiller.add(u, bins[ui], val)
            seq_idx += 1
    return seq_idx


def _reduce_bucket(
    kmers: np.ndarray,
    vals: np.ndarray,
    bins: np.ndarray,
    taxonomy,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One bucket: sorted unique keys in (bin, key) order, folded LCA
    values, and the per-key bin array (for the global index histogram)."""
    if not len(kmers):
        e = np.empty(0, dtype=np.uint64)
        return e, np.empty(0, dtype=np.uint32), e
    order = np.lexsort((vals, kmers, bins))
    kmers, vals, bins = kmers[order], vals[order], bins[order]
    first = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    starts = np.flatnonzero(first)
    keys = kmers[starts]
    key_bins = bins[starts]
    vals_out = _fold_segments(vals, starts, taxonomy)
    return keys, vals_out, key_bins


def _fold_segments(vals: np.ndarray, starts: np.ndarray, taxonomy) -> np.ndarray:
    """The set_lcas value fold per k-mer segment (vals ascending within each
    segment; see the value-word layout above)."""
    n = len(vals)
    ends = np.concatenate([starts[1:], [n]])
    last = vals[ends - 1]
    gmax = last >> _GROUP_SHIFT
    has_contam = (last & _CONTAM_BIT) != 0

    out = np.zeros(len(starts), dtype=np.uint32)

    if has_contam.any():
        # earliest contaminant claim in the winning group: pairs of that
        # group sort (non-contam..., contam by seq_idx); the first contam
        # pair is the minimum val >= (gmax<<56 | contam bit)
        seg_of = np.repeat(np.arange(len(starts)), ends - starts)
        thresh = (gmax << _GROUP_SHIFT) | _CONTAM_BIT
        is_win_contam = vals >= thresh[seg_of]
        masked = np.where(is_win_contam, vals, np.uint64(0xFFFFFFFFFFFFFFFF))
        first_contam = np.minimum.reduceat(masked, starts)
        code = first_contam & np.uint64(3)
        contam_tid = np.where(code == 1, TID_CONTAMINANT1, TID_CONTAMINANT2).astype(
            np.uint32
        )
        out[has_contam] = contam_tid[has_contam]

    fold_seg = ~has_contam
    if fold_seg.any():
        seg_of = np.repeat(np.arange(len(starts)), ends - starts)
        in_gmax = (vals >> _GROUP_SHIFT) == gmax[seg_of]
        taxid = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        use = in_gmax & (taxid != 0) & fold_seg[seg_of]
        if use.any():
            dense = taxonomy.dense_index(taxid)
            tin = taxonomy.tin[dense].astype(np.uint64)
            # pack (tin, taxid) so segment min/max recover the Euler-extreme
            # MEMBERS, not just their tins; LCA(set) = LCA(min-tin member,
            # max-tin member)
            packed = (tin << np.uint64(32)) | taxid
            lo = np.minimum.reduceat(
                np.where(use, packed, np.uint64(0xFFFFFFFFFFFFFFFF)), starts
            )
            hi = np.maximum.reduceat(np.where(use, packed, np.uint64(0)), starts)
            have = hi != 0
            sel = fold_seg & have
            if sel.any():
                ta = (lo[sel] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                tb = (hi[sel] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                out[sel] = taxonomy.lca_pairs(ta, tb)
    return out


def _sample_boundaries(
    fastas: list[str], k: int, nt: int, n_buckets: int,
    sample_kmers: int = 2 << 20,
) -> np.ndarray | None:
    """Quantile bucket boundaries from the library's own bin distribution
    (~sample_kmers k-mers spread across EVERY library file, deterministic:
    a single-file head sample would let one organism's bin distribution
    plan buckets for a library whose later files differ). Returns None for
    a single bucket."""
    if n_buckets <= 1:
        return None
    acc: list[np.ndarray] = []
    got = 0
    per_file = max(sample_kmers // max(len(fastas), 1), 64 << 10)
    for path in fastas:
        file_got = 0
        for dna in read_sequences(path):
            if not dna.seq:
                continue
            for block in _iter_seq_blocks(dna.seq, k):
                _, bs = _extract_kmers_bins(block, k, nt)
                if len(bs):
                    acc.append(bs)
                    got += len(bs)
                    file_got += len(bs)
                if file_got >= per_file:
                    break
            if file_got >= per_file:
                break
    if not got:
        return None
    allb = np.sort(np.concatenate(acc))
    q = (np.arange(1, n_buckets) * len(allb)) // n_buckets
    # dedup: a bin heavy enough to span a quantile stays in one bucket
    return np.unique(allb[q])


def _plan_buckets(fastas: list[str], memory_budget: int) -> int:
    """Bucket count so a bucket's record load (24 B/bp, x4 sort working set)
    fits the budget; library bytes approximate pair volume (compressed
    files count x3)."""
    total = 0
    for p in fastas:
        try:
            sz = os.path.getsize(p)
        except OSError:
            sz = 0
        if p.endswith((".gz", ".bz2", ".xz", ".zst")):
            sz *= 3
        total += sz
    pair_bytes = total * 24 * 4
    n = 1
    while n < 4096 and pair_bytes / n > memory_budget:
        n *= 2
    if pair_bytes / n > memory_budget:
        # the 4096-bucket cap binds: the bounded-memory contract cannot be
        # met at this budget -- say so instead of silently swapping/OOMing
        print(
            f"WARNING: build memory budget {memory_budget/2**30:.1f} GiB is "
            f"too small for this library at the {n}-bucket cap; expect "
            f"~{pair_bytes/n/2**30:.1f} GiB per-bucket working set (raise "
            f"--build-memory or split the library)",
            file=sys.stderr,
        )
    return n


def build_database_stream(
    fastas: list[str],
    seqmap: dict[str, int],
    taxonomy,
    k: int,
    nt: int,
    min_sequence_size: int = 0,
    max_kmers: int | None = None,
    lca_order: list[list[str]] | None = None,
    memory_budget: int = 1 << 30,
    tmp_dir: str | None = None,
    verbose: bool = False,
):
    """Bounded-memory build: yields (keys, vals, bins) bucket results in kdb
    order after ONE streaming pass over the library per build phase.

    The caller consumes buckets one at a time (concatenate for an in-RAM
    BuildResult, or append straight to a .kdb file); peak memory is one
    bucket's pairs plus sort working set (~4x), governed by memory_budget,
    plus the 8*4^nt-byte index histogram every variant of this pipeline
    holds (the reference's make_index does too, krakendb.cpp:118-148).

    When max_kmers is set, block down-sampling (db_shrink.cpp:80-113)
    selects over the (bin, key)-sorted order -- the kdb order -- rather
    than key order (the reference samples Jellyfish hash order; all are
    1-per-block samples of the same set)."""
    import shutil
    import tempfile

    own_tmp = tmp_dir is None
    if tmp_dir is None:
        tmp_dir = tempfile.mkdtemp(prefix="kuniq_build_")
    else:
        os.makedirs(tmp_dir, exist_ok=True)
    nb = _plan_buckets(fastas, memory_budget)
    spiller = _PairSpiller(
        k, nt, nb, tmp_dir, _sample_boundaries(fastas, k, nt, nb)
    )
    known = set(int(t) for t in taxonomy.taxids)
    try:
        seq_idx = _emit_pass(
            spiller, fastas, seqmap, known, min_sequence_size,
            group=0, seq_idx0=0, k=k, set_only_unmapped=True, verbose=verbose,
        )
        for gi, group in enumerate(lca_order or [], start=1):
            if gi > 255:
                raise ValueError("at most 255 --lca-order groups")
            seq_idx = _emit_pass(
                spiller, group, seqmap, known, min_sequence_size,
                group=gi, seq_idx0=seq_idx, k=k,
                set_only_unmapped=False, verbose=verbose,
            )
        if seq_idx >= 1 << 53:
            raise ValueError("sequence index exceeds value-word packing")
        spiller.close()

        # db_shrink block sampling needs global positions: count uniques
        # per bucket first, then select per bucket by global index range
        sel_starts = None
        if max_kmers is not None:
            uniq_counts = []
            for i in range(spiller.n_buckets):
                ks, _, _ = spiller.load_bucket(i, keys_only=True)
                uniq_counts.append(len(np.unique(ks)) if len(ks) else 0)
            key_ct = sum(uniq_counts)
            if key_ct > max_kmers:
                block = key_ct // max_kmers
                sizes = np.full(max_kmers, block, dtype=np.int64)
                sizes[: key_ct % max_kmers] += 1
                sel = np.cumsum(sizes) - 1  # offset 1 from block end
                bucket_off = np.concatenate([[0], np.cumsum(uniq_counts)])
                sel_starts = (sel, bucket_off)

        for i in range(spiller.n_buckets):
            ks, vs, bs = spiller.load_bucket(i)
            keys, vals_out, key_bins = _reduce_bucket(ks, vs, bs, taxonomy)
            del ks, vs, bs
            if sel_starts is not None and len(keys):
                sel, bucket_off = sel_starts
                lo, hi = bucket_off[i], bucket_off[i + 1]
                local = sel[np.searchsorted(sel, lo) : np.searchsorted(sel, hi)] - lo
                keys, vals_out, key_bins = keys[local], vals_out[local], key_bins[local]
            yield keys, vals_out, key_bins
    finally:
        spiller.close()
        if own_tmp:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        else:
            spiller.cleanup()


def build_database(
    fastas: list[str],
    seqmap: dict[str, int],
    taxonomy,
    k: int,
    nt: int,
    db_dir: str | None = None,
    min_sequence_size: int = 0,
    max_kmers: int | None = None,
    lca_order: list[list[str]] | None = None,
    memory_budget: int = 1 << 30,
    tmp_dir: str | None = None,
    verbose: bool = False,
) -> BuildResult:
    """Library -> (keys, vals, offsets) database build (in-RAM result).

    A thin collector over build_database_stream: suitable whenever the
    finished database fits memory; use stream_database_to_dir for
    reference-scale builds."""
    all_keys, all_vals = [], []
    counts = np.zeros(4**nt, dtype=np.int64)
    for keys, vals, key_bins in build_database_stream(
        fastas, seqmap, taxonomy, k, nt,
        min_sequence_size=min_sequence_size, max_kmers=max_kmers,
        lca_order=lca_order, memory_budget=memory_budget,
        tmp_dir=tmp_dir, verbose=verbose,
    ):
        all_keys.append(keys)
        all_vals.append(vals)
        if len(key_bins):
            counts += np.bincount(key_bins.astype(np.int64), minlength=4**nt)
    keys = (
        np.concatenate(all_keys) if all_keys else np.empty(0, dtype=np.uint64)
    )
    vals = (
        np.concatenate(all_vals) if all_vals else np.empty(0, dtype=np.uint32)
    )
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
    return BuildResult(keys=keys, vals=vals, offsets=offsets)


def stream_database_to_dir(
    db_dir: str,
    fastas: list[str],
    seqmap: dict[str, int],
    taxonomy,
    k: int,
    nt: int,
    min_sequence_size: int = 0,
    max_kmers: int | None = None,
    lca_order: list[list[str]] | None = None,
    memory_budget: int = 1 << 30,
    tmp_dir: str | None = None,
    verbose: bool = False,
) -> dict:
    """Reference-scale build: stream buckets straight into
    <db_dir>/database.kdb + database.idx + database.kdb.counts without ever
    holding the database in memory. Returns {key_ct, seconds, keys_per_s,
    memory_budget}. Output files are byte-identical to
    write_kdb/write_index over build_database's arrays."""
    import time

    from ..formats.counts import write_counts
    from ..formats.index import write_index
    from ..formats.kdb import KdbHeader, kdb_header_bytes, pack_pairs

    t0 = time.time()
    hdr = KdbHeader(key_bits=2 * k, val_len=4, key_ct=0)

    counts = np.zeros(4**nt, dtype=np.int64)
    val_hist: dict[int, int] = {}
    key_ct = 0
    kdb_path = os.path.join(db_dir, "database.kdb")
    stream = build_database_stream(
        fastas, seqmap, taxonomy, k, nt,
        min_sequence_size=min_sequence_size, max_kmers=max_kmers,
        lca_order=lca_order, memory_budget=memory_budget,
        tmp_dir=tmp_dir, verbose=verbose,
    )
    with open(kdb_path, "wb") as f:
        f.write(kdb_header_bytes(hdr))  # key_ct=0; patched after the stream
        for keys, vals, key_bins in stream:
            if not len(keys):
                continue
            key_ct += len(keys)
            counts += np.bincount(key_bins.astype(np.int64), minlength=4**nt)
            uv, uc = np.unique(vals, return_counts=True)
            for v, c in zip(uv.tolist(), uc.tolist()):
                val_hist[v] = val_hist.get(v, 0) + c
            f.write(pack_pairs(hdr, keys, vals).tobytes())
        f.seek(0)
        f.write(
            kdb_header_bytes(
                KdbHeader(key_bits=2 * k, val_len=4, key_ct=key_ct)
            )
        )

    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
    write_index(os.path.join(db_dir, "database.idx"), nt, offsets)
    write_counts(kdb_path + ".counts", dict(sorted(val_hist.items())))
    dt = time.time() - t0
    return {
        "key_ct": key_ct,
        "seconds": round(dt, 2),
        "keys_per_s": round(key_ct / max(dt, 1e-9)),
        "memory_budget": memory_budget,
    }


def shrink_pairs(
    keys: np.ndarray, vals: np.ndarray | None, n: int, offset: int = 1
) -> tuple[np.ndarray, np.ndarray | None]:
    """Down-sample to n pairs, one per block, `offset` from the block end
    (db_shrink.cpp:80-113: the first key_ct % n blocks get an extra element)."""
    key_ct = len(keys)
    if n >= key_ct:
        return keys, vals
    block = key_ct // n
    if block < offset:
        raise ValueError(f"offset {offset} larger than block size {block}")
    sizes = np.full(n, block, dtype=np.int64)
    sizes[: key_ct % n] += 1
    sel = np.cumsum(sizes) - offset
    return keys[sel], (vals[sel] if vals is not None else None)


def expand_dynamic_taxids(
    taxonomy,
    map_lines: list[tuple[str, int, str]],
    for_assembly: bool = False,
    for_sequences: bool = False,
):
    """Pseudo-taxid expansion (set_lcas -a/-A, set_lcas.cpp:182-266).

    `map_lines` are (seqid, taxid, name) from seqid2taxid.map; returns
    (new_taxonomy, seqid->taxid map). New taxids start above 1e9 (bumped
    past any existing id + 100); assembly names and sequence ids share one
    dedup namespace, as in the reference."""
    start = NEW_TAXID_START
    for t in taxonomy.taxids:
        if int(t) >= start:
            start = int(t) + 100
    name_to_taxid: dict[str, int] = {}
    new_nodes: list[tuple[int, int, str, str]] = []
    seqmap: dict[str, int] = {}

    def get_new_taxid(name: str, parent: int, rank: str) -> int:
        nonlocal start
        existing = name_to_taxid.get(name)
        if existing is not None:
            return existing
        start += 1
        new_nodes.append((start, parent, name, rank))
        name_to_taxid[name] = start
        return start

    for seqid, taxid, name in map_lines:
        if seqid in seqmap:
            continue  # first mapping wins (set_lcas.cpp:233-237)
        orig = taxid
        if for_assembly and name:
            taxid = get_new_taxid(name, taxid, "assembly")
        if for_sequences and orig not in (TID_HUMAN, TID_MOUSE):
            taxid = get_new_taxid(seqid, taxid, "sequence")
        seqmap[seqid] = taxid

    return taxonomy.with_added_nodes(new_nodes), seqmap
