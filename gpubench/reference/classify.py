"""Plain NumPy reference of KrakenUniq's classification of a sample.

From a database's pairs (`database.kdb`) and taxonomy (`taxDB`), both as
the benchmark's synthesiser wrote them, and the reads the benchmark made, it
works out what the classifier must print:

  * each read's kraken line (classify.cpp:980-1010): C or U, the read id,
    the call, the length and the run-length list of each k-mer's stored
    taxon (0 for a miss, A for a k-mer holding a non-ACGT base);
  * the call: each distinct hit taxon scores the hits on its root path, the
    best score wins and ties go to the lowest common ancestor of the tied
    taxa (krakenutil.cpp:149-200);
  * the report's numbers for every taxon it prints (taxdb.hpp:928-1123):
    reads in the clade and at the taxon, the HLL estimate of the clade's
    distinct k-mers, k-mers over distinct k-mers (`dup`), distinct k-mers
    over the clade's database k-mers (`cov`) and the clade's share of the
    reads. Every counted k-mer (a miss too, under taxon 0) goes into its
    taxon's counter one work unit of >= 500 kbp at a time; a unit whose
    counter sees more than 2^p / 4 distinct encodings turns that taxon's
    counter dense (hyperloglogplus.cpp:496-498, classify.cpp:525-544).

It imports nothing of the program. `lookup="fingerprint32"` is the control
that a test and `control.py` run in the program's place: it matches k-mers
on the top 32 bits of their murmur3 hash instead of on all their bits, as
a compact table that keeps fingerprints would.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import hll
from .kdb import read_pairs
from .kmers import encode_hash_32, murmur3_finalizer, read_kmers
from .taxonomy import Closure, Tree

UNIT_BP = 500_000  # a work unit's bases (classify.cpp:38)
HLL_P = 12  # every counter's precision (hyperloglogplus.hpp:87)
_BLOCK = 1 << 16  # reads a block of the k-mer pass
# NumPy's sorts, searches and ufuncs release the interpreter lock, so the
# blocks of the k-mer pass and the lookup run in threads
_THREADS = min(8, os.cpu_count() or 1)


def _distinct(x: np.ndarray, counts: bool = False):
    """np.unique by a sort: NumPy 2.3's hash-based unique takes minutes on
    arrays where a sort takes seconds."""
    s = np.sort(np.asarray(x))
    first = np.empty(len(s), dtype=bool)
    first[:1] = True
    np.not_equal(s[1:], s[:-1], out=first[1:])
    if not counts:
        return s[first]
    return s[first], np.diff(np.append(np.flatnonzero(first), len(s)))


def _blocks(n: int, parts: int) -> list:
    step = max(1, -(-n // parts))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def _each(fn, spans) -> None:
    with ThreadPoolExecutor(_THREADS) as pool:
        for f in [pool.submit(fn, a, b) for a, b in spans]:
            f.result()


@dataclasses.dataclass
class Reads:
    """The sample: ids, and codes uint8 [n, L] (0-3 for ACGT, 4 for N, 5
    past a read's end) with each read's length."""

    ids: list
    codes: np.ndarray
    lengths: np.ndarray


@dataclasses.dataclass
class Result:
    lines: list  # bytes, one kraken line a read, in read order
    report: dict  # taxid -> {"%", "reads", "taxReads", "kmers", "dup", "cov"}


def cpp_float(v: float, precision: int) -> str:
    """`os << setprecision(p) << v` as glibc prints it."""
    if math.isnan(v):
        return "-nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.{precision}g}"


def _lookup_exact(keys, vals, queries):
    """Each query's stored value, 0 where it is no key. The keys that can
    match are screened by a bit per 28 low bits of the queries, then
    sorted, and the sorted queries searched in them."""
    bits = 28
    mask = np.uint64((1 << bits) - 1)
    flag = np.zeros(1 << bits, dtype=bool)
    flag[(queries & mask).astype(np.int64)] = True
    pick = flag[(keys & mask).astype(np.int64)]
    del flag
    ck, cv = keys[pick], vals[pick]
    order = np.argsort(ck)
    ck, cv = ck[order], cv[order]
    return _search(ck, cv, queries)


def _lookup_fingerprint32(keys, vals, queries):
    fk = (murmur3_finalizer(keys) >> np.uint64(32)).astype(np.uint32)
    order = np.argsort(fk)
    fq = (murmur3_finalizer(queries) >> np.uint64(32)).astype(np.uint32)
    return _search(fk[order], vals[order], fq)


def _search(sorted_keys, sorted_vals, queries):
    out = np.zeros(len(queries), dtype=np.uint32)
    if not len(sorted_keys):
        return out

    def part(a, b):
        q = queries[a:b]
        qo = np.argsort(q)
        qs = q[qo]
        pos = np.minimum(np.searchsorted(sorted_keys, qs), len(sorted_keys) - 1)
        hit = sorted_keys[pos] == qs
        out[a + qo[hit]] = sorted_vals[pos[hit]]

    _each(part, _blocks(len(queries), 4 * _THREADS))
    return out


def _lines(reads: Reads, calls, codes, valid, n_kmers) -> list:
    """The kraken lines: the runs of each read's k-mer codes (a taxid, or
    -1 for an ambiguous k-mer) over its valid lanes."""
    n, w = codes.shape
    change = valid.copy()
    change[:, 1:] &= codes[:, 1:] != codes[:, :-1]
    starts = np.flatnonzero(change)
    rows = starts // max(w, 1)
    ends = np.append(starts[1:], 0)
    last = np.append(rows[1:] != rows[:-1], True)
    ends[last] = rows[last] * w + n_kmers[rows[last]]
    vals = codes.reshape(-1)[starts].tolist()
    lens = (ends - starts).tolist()
    pieces = [("A" if v < 0 else str(v)) + ":" + str(m) for v, m in zip(vals, lens)]
    at = np.searchsorted(rows, np.arange(n + 1)).tolist()
    out = []
    for i in range(n):
        c = int(calls[i])
        hl = " ".join(pieces[at[i]:at[i + 1]]) if at[i + 1] > at[i] else "0:0"
        out.append(f"{'C' if c else 'U'}\t{reads.ids[i]}\t{c}\t{int(reads.lengths[i])}\t{hl}\n".encode())
    return out


def _calls(taxa: np.ndarray, hit: np.ndarray, clo: Closure) -> np.ndarray:
    """Each read's call (taxid, 0 if no hit)."""
    n, w = taxa.shape
    calls = np.zeros(n, dtype=np.int64)
    rows, cols = np.nonzero(hit)
    if not len(rows):
        return calls
    ti = clo.index(taxa[rows, cols])
    nt = len(clo.taxids)
    pair = rows.astype(np.int64) * nt + ti
    pairs, counts = _distinct(pair, counts=True)
    pr, pt = pairs // nt, pairs % nt
    # score: the hits on each candidate's root path
    score = np.zeros(len(pairs), dtype=np.int64)
    for d in range(clo.chain.shape[1]):
        a = clo.chain[pt, d]
        on = np.flatnonzero(a >= 0)
        key = pr[on] * nt + a[on]
        pos = np.minimum(np.searchsorted(pairs, key), len(pairs) - 1)
        found = pairs[pos] == key
        score[on[found]] += counts[pos[found]]
    starts = np.flatnonzero(np.concatenate([[True], pr[1:] != pr[:-1]]))
    best = np.maximum.reduceat(score, starts)
    read_of = pr[starts]
    tied = score == np.repeat(best, np.diff(np.concatenate([starts, [len(pr)]])))
    tr, tt = pr[tied], pt[tied]
    # fold the tied candidates of each read into their LCA
    first = np.concatenate([[True], tr[1:] != tr[:-1]])
    cur = np.full(n, -1, dtype=np.int64)
    cur[tr[first]] = tt[first]
    rank = np.arange(len(tr)) - np.maximum.accumulate(np.where(first, np.arange(len(tr)), 0))
    for r in range(1, int(rank.max()) + 1 if len(rank) else 1):
        sel = rank == r
        cur[tr[sel]] = clo.lca[cur[tr[sel]], tt[sel]]
    calls[read_of] = clo.taxids[cur[read_of]]
    return calls


def _fold(taxa, counted, enc, units, tree_taxa):
    """The counters' final state after one pass, per counted taxon: total
    k-mers, whether any unit turned it dense, its distinct encodings and its
    registers. `tree_taxa`: the taxa counted (0 first), indexing ti."""
    ti = np.searchsorted(tree_taxa, taxa[counted])
    lane_unit = np.broadcast_to(units[:, None], taxa.shape)[counted].astype(np.uint64)
    # a sort key of unit, taxon and encoding: the taxon's bits as it needs
    tb = max(1, (len(tree_taxa) - 1).bit_length())
    if (int(units.max(initial=0)) + 1).bit_length() + tb > 32:
        raise ValueError("too many work units and taxa for the fold's 64-bit keys")
    e = enc[counted]
    key = (lane_unit << np.uint64(32 + tb)) | (ti.astype(np.uint64) << np.uint64(32)) | e.astype(np.uint64)
    s = np.sort(key)
    new = np.concatenate([[True], s[1:] != s[:-1]])
    seg = s >> np.uint64(32)
    seg_start = np.flatnonzero(np.concatenate([[True], seg[1:] != seg[:-1]]))
    seg_n = np.diff(np.concatenate([seg_start, [len(s)]]))
    seg_u = np.add.reduceat(new.astype(np.int64), seg_start)
    seg_ti = (seg[seg_start] & np.uint64((1 << tb) - 1)).astype(np.int64)
    seg_unit = (seg[seg_start] >> np.uint64(tb)).astype(np.int64)
    th = (1 << HLL_P) // 4
    dense_seg = seg_u > th
    for j in np.flatnonzero(seg_u == th):
        # the switch fires only if an insert follows the one that filled the
        # set: the unit's stream of this taxon, in read and lane order
        in_unit = units == seg_unit[j]
        tx = taxa[in_unit]
        stream = enc[in_unit][counted[in_unit] & (tx == tree_taxa[seg_ti[j]])]
        _, first = np.unique(stream, return_index=True)
        dense_seg[j] = int(first.max()) < len(stream) - 1
    n_taxa = len(tree_taxa)
    nk = np.bincount(seg_ti, weights=seg_n, minlength=n_taxa).astype(np.int64)
    dense = np.bincount(seg_ti, weights=dense_seg, minlength=n_taxa) > 0
    te = _distinct(s[new] & np.uint64((1 << (32 + tb)) - 1))  # distinct (taxon, encoding)
    te_ti = (te >> np.uint64(32)).astype(np.int64)
    te_enc = (te & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bounds = np.searchsorted(te_ti, np.arange(n_taxa + 1))
    encs = [te_enc[bounds[i]:bounds[i + 1]] for i in range(n_taxa)]
    regs = np.zeros((n_taxa, 1 << HLL_P), dtype=np.uint8)
    if len(te):
        from .kmers import decode_rank

        np.maximum.at(regs.reshape(-1), te_ti * (1 << HLL_P) + (te_enc >> np.uint32(32 - HLL_P)).astype(np.int64),
                      decode_rank(te_enc, HLL_P))
    return nk, dense, encs, regs


def _unit_of_reads(lengths: np.ndarray) -> np.ndarray:
    """Greedy work units: a unit ends at the read that brings it to
    UNIT_BP bases (classify.cpp:511-521)."""
    units = np.empty(len(lengths), dtype=np.int64)
    u = acc = 0
    for i, m in enumerate(lengths.tolist()):
        units[i] = u
        acc += m
        if acc >= UNIT_BP:
            u, acc = u + 1, 0
    return units


def run(db_dir: str, reads: Reads, lookup: str = "exact") -> Result:
    """What the classifier prints for the sample `reads`: its kraken lines
    and its report."""
    k, keys, vals = read_pairs(os.path.join(db_dir, "database.kdb"))
    tree = Tree.from_taxdb(os.path.join(db_dir, "taxDB"))
    n, length = reads.codes.shape
    w = max(length - k + 1, 0)
    canon = np.zeros((n, w), dtype=np.uint64)
    ambig = np.zeros((n, w), dtype=bool)

    def kmer_block(a, b):
        canon[a:b], ambig[a:b] = read_kmers(reads.codes[a:b], k)

    _each(kmer_block, [(a, min(n, a + _BLOCK)) for a in range(0, n, _BLOCK)])
    n_kmers = np.maximum(reads.lengths.astype(np.int64) - (k - 1), 0)
    valid = np.arange(w)[None, :] < n_kmers[:, None]
    counted = valid & ~ambig
    taxa = np.zeros((n, w), dtype=np.uint32)
    find = _lookup_exact if lookup == "exact" else _lookup_fingerprint32
    taxa[counted] = find(keys, vals, canon[counted])
    hit = taxa != 0
    per_value = np.bincount(vals)  # database k-mers a taxid
    value_set = np.flatnonzero(per_value)
    del keys
    clo = Closure(tree, value_set)
    calls = _calls(taxa, hit, clo)

    lines = _lines(reads, calls, np.where(ambig, -1, taxa.astype(np.int64)), valid, n_kmers)
    enc = np.zeros((n, w), dtype=np.uint32)

    def enc_block(a, b):
        sel = counted[a:b]
        enc[a:b][sel] = encode_hash_32(murmur3_finalizer(canon[a:b][sel]), HLL_P)

    _each(enc_block, [(a, min(n, a + _BLOCK)) for a in range(0, n, _BLOCK)])
    del canon
    tree_taxa = _distinct(np.concatenate([[0], taxa[counted]])).astype(np.int64)
    nk, dense, encs, regs = _fold(taxa, counted, enc, _unit_of_reads(reads.lengths), tree_taxa)
    called, n_called = _distinct(calls, counts=True)
    return Result(lines, _report(clo, value_set, per_value[value_set], tree_taxa, nk, dense, encs, regs,
                                 dict(zip(called.tolist(), n_called.tolist()))))


def _report(clo: Closure, db_t, db_n, tree_taxa, nk, dense, encs, regs, reads_at) -> dict:
    """The printed taxa's numbers; `reads_at`: reads called to each taxid."""
    # database k-mers per taxon; the reference's counts-file reader takes the
    # last line (the largest taxid) twice (taxdb.hpp:867-885)
    db_n = db_n.astype(np.int64)
    db_n[-1] *= 2
    rows = {}
    nt = len(clo.taxids)
    in_tree = tree_taxa != 0
    t_rows = np.full(len(tree_taxa), -1)
    t_rows[in_tree] = clo.index(tree_taxa[in_tree])
    called_rows = {int(clo.index(np.array([t]))[0]): r for t, r in reads_at.items() if t != 0}
    clade_reads = np.zeros(nt, dtype=np.int64)
    for row, r in called_rows.items():
        clade_reads[clo.anc[row]] += r
    db_rows = clo.index(db_t.astype(np.int64))
    gsize = np.zeros(nt, dtype=np.int64)
    np.add.at(gsize, db_rows, db_n)
    gclade = clo.anc.T.astype(np.int64) @ gsize  # every member's database k-mers
    root = np.flatnonzero(clo.taxids == 1)
    total = reads_at.get(0, 0) + (int(clade_reads[root[0]]) if len(root) else 0)

    def line(members, reads, tax_reads, gs):
        n_obs = int(nk[members].sum())
        if dense[members].any():
            uniq = hll.estimate_dense(regs[members].max(axis=0), n_obs)
        else:
            parts = [encs[m] for m in members.tolist()]
            uniq = hll.estimate_sparse(_distinct(np.concatenate(parts)) if parts else np.empty(0, np.uint32),
                                       HLL_P, n_obs)
        if uniq == 0:
            dup = float("nan") if n_obs == 0 else float("inf")
        else:
            dup = n_obs / uniq
        return {"%": cpp_float(100.0 * reads / total, 4), "reads": str(reads), "taxReads": str(tax_reads),
                "kmers": str(uniq), "dup": cpp_float(dup, 3),
                "cov": "NA" if gs == 0 else cpp_float(uniq / gs, 4)}

    if reads_at.get(0, 0):
        rows[0] = line(np.flatnonzero(tree_taxa == 0), reads_at[0], reads_at[0], 0)
    for c in np.flatnonzero(clade_reads > 0).tolist():
        members = np.flatnonzero(in_tree & clo.anc[np.maximum(t_rows, 0), c])
        taxid = int(clo.taxids[c])
        rows[taxid] = line(members, int(clade_reads[c]), reads_at.get(taxid, 0), int(gclade[c]))
    return rows


def parse_report(path: str) -> dict:
    """The program's report (header, then one row a taxon) as taxid ->
    the columns the reference computes."""
    rows = {}
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        for ln in f:
            rec = dict(zip(head, ln.rstrip("\n").split("\t")))
            rows[int(rec["taxID"])] = {key: rec.get(key) for key in ("%", "reads", "taxReads", "kmers", "dup", "cov")}
    return rows
