"""The redesigned fallback lookups on the CPU against the JAX package, on the
same seeded numpy inputs, with exact equality.

The binary search's words entry (`bsearch_words`: the bins and canonical
k-mers from the span route's packed words, one database's search of the
lanes still unclassified) in its plain version and in the plain mirror of
its kernel's algorithm (`_words_sliding`: the sliding-window bins of
`kmer_bins_sliding`, then each lane's own stepwise search) against the JAX
package's `lookup_kmers` fed by its own minimizers and canonical k-mers,
merged over databases as its classify step merges them. The reads carry
planted nt-mers whose minimizer values are small, so that their bins fall
in a table of NB bins whatever nt is; the tables give the queried bins 0,
1, 2^n_iter - 1, 2^n_iter, BIG and more keys. The query/bins entry on runs
of queries that share a bin; and the fused probe's plain version and its
two-round mirror (`probe_fused_rounds`) against the JAX package's
`_probe_fused` on hand-laid edge rows and on a real build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.kmer import ops as jkops
from krakenuniq_tpu.lookup import lookup_kmers as jax_lookup_kmers
from krakenuniq_tpu.lookup.hash_lookup import _probe_fused as jax_probe_fused
from krakenuniq_tpu_torch.classify import device_step as ds
from krakenuniq_tpu_torch.classify.device_step import bsearch_words, bsearch_words_plain, pack_input
from krakenuniq_tpu_torch.db.hash_table import GOLDEN, build_hash_table
from krakenuniq_tpu_torch.kmer import encode_batch
from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, probe_fused_plain, probe_fused_rounds
from krakenuniq_tpu_torch.lookup.xla_lookup import lookup_kmers, lookup_kmers_plain
from krakenuniq_tpu_torch.utils.bits import INDEX2_XOR_MASK, murmur3_finalizer

T = torch.from_numpy
NB = 16_384  # bins a test table covers (4^7, all of nt = 7's)
# the table's last bin + 1 for nt > 7: planted bins in [NB_END, NB) lie past
# it; at nt = 7 the bins are minima of 15 values of 4^7, all small, and the
# table ends at NB_END_7
NB_END, NB_END_7 = 15_000, 3_000
MISSING_TAXID = 987_654_321
BIG = 128  # a bin of many keys (a searched lane's bin holds ~35 on real reads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several pytest-xdist workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc(c: int, n: int) -> int:
    """The reverse complement of an n-mer code (first base in the high bits)."""
    r = 0
    for i in range(n):
        r = (r << 2) | (3 - ((c >> (2 * i)) & 3))
    return r


def _pool(rng, nt: int, size: int = 24):
    """nt-mers whose minimizer values (xm ^ canonical) lie in [10,000, NB):
    canonical forward codes c with c <= rc(c)."""
    xm = int(INDEX2_XOR_MASK) & ((1 << 2 * nt) - 1)
    out = []
    while len(out) < size:
        c = xm ^ int(rng.integers(10_000, min(NB, 4 ** nt)))
        if c <= _rc(c, nt):
            out.append(c)
    return out


def _reads(seed: int, k: int, nt: int, b: int = 40, lb: int = 160, lengths=None):
    """Random reads with nt-mers of the pool planted every nt to k + 1
    bases, so that many windows take a pool nt-mer's small value as their
    bin; 2% N bases; lengths 0, k - 1, k and LB, then random (or the given
    ones). Returns encode_batch's (codes, ambig, lengths)."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng, nt)
    if lengths is None:
        lengths = [0, k - 1, k, lb] + [int(x) for x in rng.integers(0, lb + 1, b - 4)]
    seqs = []
    for i in range(b):
        n = lengths[i % len(lengths)]
        codes = rng.integers(0, 4, n)
        p = int(rng.integers(0, nt))
        while p + nt <= n:
            c = pool[int(rng.integers(len(pool)))]
            codes[p:p + nt] = [(c >> 2 * (nt - 1 - j)) & 3 for j in range(nt)]
            p += nt + int(rng.integers(0, k - nt + 2))
        s = np.array(list("ACGT"))[codes]
        s[rng.random(n) < 0.02] = "N"
        seqs.append("".join(s))
    enc = encode_batch(seqs, lb=lb, batch=b)
    return enc.codes, enc.ambig, enc.lengths


def _jax_lanes(codes, ambig, lengths, k: int, nt: int):
    """The JAX package's canonical k-mers, minimizer bins (uint64) and the
    step's search mask."""
    jc = jnp.asarray(codes)
    canon = np.asarray(jkops.canonical_representation(jkops.pack_windows(jc, k), k))
    bins = np.asarray(jkops.minimizers(jc, k, nt))
    w = codes.shape[1] - k + 1
    search = (np.arange(w)[None, :] < np.maximum(lengths - (k - 1), 0)[:, None]) & ~np.asarray(
        jkops.window_any(jnp.asarray(ambig), k))
    return canon, bins, search


def _end(nt: int) -> int:
    return NB_END_7 if nt <= 7 else NB_END


def _table(rng, canon, bins, search, n_iter: int, lo_bin: int, end: int, share: float = 0.6,
           missing: float = 0.0):
    """Sorted planes over bins [0, end): the queried bins in [lo_bin, end)
    take the sizes 0, 1, 2^n_iter - 1, 2^n_iter, BIG, BIG + 7 and a
    few small ones in turn, holding up to `share` of their queried
    k-mers, the rest junk; the other bins a fifth empty, the rest a few junk
    keys. `missing` of the values carry a taxid the taxonomy lacks (dense id
    0). Returns numpy (keys uint64, vals uint32, vals_dense int32, offsets
    int64) and the size of each queried bin."""
    sel = search & (bins < end)
    qb, qk = bins[sel].astype(np.int64), canon[sel]
    sizes = np.where(rng.random(end) < 0.2, 0, rng.geometric(0.3, end)).astype(np.int64)
    menu = np.array([0, 1, 2 ** n_iter - 1, 2 ** n_iter, BIG, BIG + 7, 3, 6, 10])
    queried = np.unique(qb)
    ours = queried[queried >= lo_bin]
    sizes[ours] = menu[np.arange(len(ours)) % len(menu)]
    keys = rng.integers(0, 1 << 62, int(sizes.sum()), dtype=np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    for d in queried:
        real = np.unique(qk[qb == d])
        real = real[rng.random(len(real)) < share][: sizes[d]]
        keys[offsets[d]:offsets[d] + len(real)] = real
    bin_of = np.repeat(np.arange(end), sizes)
    keys = keys[np.lexsort((keys, bin_of))]
    vals = rng.integers(1, 1 << 32, len(keys), dtype=np.uint64).astype(np.uint32)
    vals_dense = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    gone = rng.random(len(keys)) < missing
    vals[gone], vals_dense[gone] = MISSING_TAXID, 0
    return (keys, vals, vals_dense, offsets), {int(d): int(sizes[d]) for d in queried}


def _shard(planes, bin_start: int):
    """A shard's planes from bin_start on (np), as the JAX package cuts them."""
    keys, vals, vals_dense, offsets = planes
    k0 = int(offsets[bin_start])
    return keys[k0:], vals[k0:], vals_dense[k0:], offsets[bin_start:] - k0


def _port_plane(shard, bin_start: int):
    keys, vals, vals_dense, offsets = shard
    return (T(keys.view(np.int64)), T(vals.view(np.int32)), T(vals_dense), T(offsets), bin_start)


def _jax_merge(canon, bins, search, shards, n_iter: int):
    """The JAX classify step's bsearch merge (krakenuniq_tpu/classify/
    device_step.py:157-212): databases in order, each searched on the lanes
    still unfound, a hit keyed on the stored taxid."""
    taxon = np.zeros(search.shape, np.uint32)
    taxon_dense = np.zeros(search.shape, np.int32)
    found = np.zeros(search.shape, bool)
    for shard, bin_start in shards:
        remaining = search & ~found
        t, td = (np.asarray(a) for a in jax_lookup_kmers(
            *(jnp.asarray(a) for a in shard), jnp.asarray(canon), jnp.asarray(bins), jnp.asarray(remaining),
            n_iter, bin_start))
        taxon = np.where(remaining, t, taxon)
        taxon_dense = np.where(remaining, td, taxon_dense)
        found |= t != 0
    return taxon, taxon_dense


def _port_chain(fn, feed, planes, k: int, nt: int, n_iter: int, **kw):
    taxon = taxon_dense = None
    for plane in planes:
        taxon, taxon_dense = fn(plane, *feed, k, nt, n_iter, taxon, taxon_dense, **kw)
    return taxon.numpy().view(np.uint32), taxon_dense.numpy()


def _words_sliding(plane, codes, ambig, lengths, k: int, nt: int, n_iter: int, taxon=None, taxon_dense=None):
    """The `bsearch_words` kernel's algorithm in plain torch: the bins by
    `kmer_bins_sliding` (one nt-mer a base position, the van Herk/Gil-Werman
    minimum) from the packed words, then each lane's own search
    (`lookup_kmers_plain`) and the merge on the lanes still 0."""
    keys, vals, vals_dense, offsets, bin_start = plane
    _, lanes = ds._words_lanes(codes, ambig, lengths, k, taxon)
    canon, bins = ds.kmer_bins_sliding(codes, 16 * codes.shape[1], k, nt)
    t, td = lookup_kmers_plain(keys, vals, vals_dense, offsets, canon, bins, lanes, n_iter, bin_start)
    return ds._words_merge(t, td, lanes, taxon, taxon_dense)


def _check_words(codes, ambig, lengths, k, nt, shards, n_iter):
    """Every port form of the words entry against the JAX merge; returns the
    JAX taxa and the search mask."""
    canon, bins, search = _jax_lanes(codes, ambig, lengths, k, nt)
    want_t, want_td = _jax_merge(canon, bins, search, shards, n_iter)
    feed = (*pack_input(T(codes), T(ambig)), T(lengths))
    planes = [_port_plane(s, bs) for s, bs in shards]
    for name, fn in (("plain", bsearch_words_plain), ("wrapper", bsearch_words), ("sliding", _words_sliding)):
        t, td = _port_chain(fn, feed, planes, k, nt, n_iter)
        np.testing.assert_array_equal(t, want_t, err_msg=f"{name}: taxon")
        np.testing.assert_array_equal(td, want_td, err_msg=f"{name}: taxon_dense")
    return want_t, canon, bins, search


# (k, nt, bin_start): each width with a whole table and a shard; at nt = 7
# the bins all lie below 12,345 (see NB_END_7), so its shard starts at 1,234
WORD_CASES = [(31, 12, 0), (31, 12, 12_345), (21, 7, 0), (21, 7, 1_234), (31, 15, 0), (31, 15, 12_345),
              (31, 20, 0), (31, 20, 12_345)]


@pytest.mark.parametrize("n_iter", [4, 8])
@pytest.mark.parametrize("k,nt,bin_start", WORD_CASES)
def test_bsearch_words_match_jax(k, nt, bin_start, n_iter):
    """One database: reads shorter than k and of 0 bases, N bases, bins
    below bin_start and past the table's end, bins of 0, 1, 2^n_iter - 1,
    2^n_iter, BIG and BIG + 7 keys (n_iter = 4 is below what the
    largest bins need: their search stops short, in the reference too)."""
    rng = np.random.default_rng(1000 * k + 10 * nt + n_iter + bin_start)
    codes, ambig, lengths = _reads(k * nt + n_iter, k, nt)
    canon, bins, search = _jax_lanes(codes, ambig, lengths, k, nt)
    end = _end(nt)
    planes, sizes = _table(rng, canon, bins, search, n_iter, bin_start, end)
    want_t, _, _, _ = _check_words(codes, ambig, lengths, k, nt, [(_shard(planes, bin_start), bin_start)], n_iter)
    b = bins.astype(np.int64)
    inside = search & (b >= bin_start) & (b < end)
    got_sizes = {sizes[int(x)] for x in np.unique(b[inside])}
    assert {0, 1, 2 ** n_iter - 1, 2 ** n_iter, BIG, BIG + 7} <= got_sizes, got_sizes
    assert (want_t != 0).sum() > 20 and (search & (b >= end)).any()
    assert (search & (b < bin_start)).any() == (bin_start > 0)
    in_read = np.arange(search.shape[1])[None, :] < np.maximum(lengths - (k - 1), 0)[:, None]
    assert (lengths < k).any() and (in_read & ~search).any()  # short reads, ambiguous lanes


@pytest.mark.parametrize("k,nt", [(31, 12), (21, 7)])
def test_bsearch_words_hierarchy_matches_jax(k, nt):
    """Two databases searched in order (the second a shard): keys in both
    with different values (the first database's hit wins), values whose
    taxid the taxonomy lacks (dense id 0: still a hit, so the second
    database is not asked for the lane)."""
    rng = np.random.default_rng(7 * k + nt)
    codes, ambig, lengths = _reads(3 * k + nt, k, nt)
    canon, bins, search = _jax_lanes(codes, ambig, lengths, k, nt)
    end, bs = _end(nt), 12_345 if nt > 7 else 1_234
    first, _ = _table(rng, canon, bins, search, 8, 0, end, share=0.5, missing=0.3)
    second, _ = _table(rng, canon, bins, search, 8, bs, end, share=0.8)
    shards = [(_shard(first, 0), 0), (_shard(second, bs), bs)]
    want_t, _, _, _ = _check_words(codes, ambig, lengths, k, nt, shards, 8)
    only_first, _ = _jax_merge(canon, bins, search, shards[:1], 8)
    assert (want_t == MISSING_TAXID).any() and (want_t[only_first == 0] != 0).any()
    assert (want_t[only_first != 0] == only_first[only_first != 0]).all()


@pytest.mark.parametrize("k,nt", [(31, 12), (31, 20)])
def test_bsearch_words_long_rows(k, nt):
    """Rows of 8,192 bases, which the kernel cuts into tiles, with reads of
    8,192 to 10 bases."""
    rng = np.random.default_rng(k + nt)
    codes, ambig, lengths = _reads(k + 5 * nt, k, nt, b=6, lb=8192, lengths=[8192, 8100, 6000, 4200, 150, 10])
    canon, bins, search = _jax_lanes(codes, ambig, lengths, k, nt)
    planes, _ = _table(rng, canon, bins, search, 8, 0, _end(nt))
    want_t, _, _, _ = _check_words(codes, ambig, lengths, k, nt, [(_shard(planes, 0), 0)], 8)
    assert (want_t != 0).sum() > 500


def _sorted_planes(rng, n_bins):
    sizes = np.where(rng.random(n_bins) < 0.2, 0, rng.geometric(0.1, n_bins))
    sizes[:8] = [0, 1, 7, 8, BIG, BIG + 1, 200, 3]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    keys = np.sort(rng.integers(0, 1 << 62, int(offsets[-1]), dtype=np.uint64))
    vals = rng.integers(0, 1 << 32, len(keys), dtype=np.uint64).astype(np.uint32)
    vals_dense = rng.integers(0, 1 << 20, len(keys)).astype(np.int32)
    return keys, vals, vals_dense, offsets, sizes


@pytest.mark.parametrize("max_run", [12, 1])
@pytest.mark.parametrize("n_iter", [3, 9])
@pytest.mark.parametrize("bin_start", [0, 37])
def test_lookup_kmers_runs_matches_jax(bin_start, n_iter, max_run):
    """The query/bins entry's plain version and wrapper against the JAX
    package's lookup_kmers on runs of consecutive lanes with one bin, as a
    read's k-mers give them: runs of 1 to max_run lanes a bin, hits and
    junk, bins of 0, 1, 7, 8, BIG, BIG + 1 and 200 keys, bins out of range
    on both sides, invalid lanes inside runs."""
    rng = np.random.default_rng(100 * bin_start + 10 * n_iter + max_run)
    keys, vals, vals_dense, offsets, sizes = _sorted_planes(rng, 4 ** 5)
    n_bins = len(sizes)
    run_bins = rng.integers(-2, n_bins + 2, 700)
    run_bins[:16] = np.arange(16) % 8  # every sized bin, twice
    lens = rng.integers(1, max_run + 1, len(run_bins))
    bins = np.repeat(run_bins, lens)
    q = rng.integers(0, 1 << 62, len(bins), dtype=np.uint64)
    ok = (bins >= 0) & (bins < n_bins)
    s = np.where(ok, sizes[np.clip(bins, 0, n_bins - 1)], 0)
    pick = ok & (s > 0) & (rng.random(len(bins)) < 0.7)
    q[pick] = keys[offsets[bins[pick]] + rng.integers(0, 1 << 30, int(pick.sum())) % s[pick]]
    valid = rng.random(len(bins)) >= 0.05
    bins = bins.astype(np.int64) + bin_start
    shard = (keys, vals, vals_dense, offsets)
    jt, jtd = jax_lookup_kmers(*(jnp.asarray(a) for a in shard), jnp.asarray(q), jnp.asarray(bins.view(np.uint64)),
                               jnp.asarray(valid), n_iter, bin_start)
    args = (T(keys.view(np.int64)), T(vals.view(np.int32)), T(vals_dense), T(offsets), T(q.view(np.int64)),
            T(bins), T(valid), n_iter, bin_start)
    for name, (t, td) in (("plain", lookup_kmers_plain(*args)), ("wrapper", lookup_kmers(*args))):
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(jt), err_msg=name)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jtd), err_msg=name)
    assert (np.asarray(jt) != 0).sum() > len(bins) // 4


# ------------------------------------------------------------- fused probe


def _slot(hc: np.uint64, lb: int, val: int, choice: int):
    """The (tag, word) a fused slot holds for the probe value hc."""
    with np.errstate(over="ignore"):
        tag = np.uint32((hc << np.uint64(lb)) >> np.uint64(32))
    spare = int(hc) & ((1 << (32 - lb)) - 1)
    return tag, np.uint32((spare << (lb - 1)) | val | (choice << 31))


def _buckets(h: np.uint64, lb: int):
    with np.errstate(over="ignore"):
        return int(h >> np.uint64(64 - lb)), int((h * GOLDEN) >> np.uint64(64 - lb))


def _edge_table(lb: int = 8):
    """A hand-laid fused plane and queries: (fused uint32 [2^lb, 4], h
    uint64 [n], the value the probe must give, the row that answers it).
    Values fit lb - 1 bits; no key overwrites another's slot."""
    rng = np.random.default_rng(lb)
    fused = np.zeros((1 << lb, 4), np.uint32)
    qs, want, row = [], [], []

    def put(h, val, choice, slot):
        b = _buckets(h, lb)[choice]
        if fused[b, 2 * slot: 2 * slot + 2].any():
            return False
        hc = h if choice == 0 else np.uint64((int(h) * int(GOLDEN)) & (2 ** 64 - 1))
        fused[b, 2 * slot], fused[b, 2 * slot + 1] = _slot(hc, lb, val, choice)
        return True

    def add(make, val, choice, slot, answers):
        h = make()
        while not put(h, val, choice, slot):
            h = make()
        qs.append(h), want.append(val), row.append(answers)

    def rand_h():
        return np.uint64(int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2)))

    def tag0_h():  # first-choice tag 0: bits [32 - lb, 64 - lb) of h zero
        return np.uint64((int(rng.integers(0, 1 << lb)) << (64 - lb)) | int(rng.integers(1, 1 << (32 - lb))))

    def same_h():  # b1 == b2
        h = rand_h()
        while len(set(_buckets(h, lb))) != 1:
            h = rand_h()
        return h

    for i in range(20):  # keys in their second choice (slot 1 of b2)
        add(rand_h, 10 + i, 1, 1, 2)
    for i in range(20):  # keys in their first choice
        add(rand_h, 40 + i, 0, 0, 1)
    for i in range(6):  # pinned keys (first-choice tag 0), in b1
        add(tag0_h, 70 + i, 0, 1, 1)
    for i in range(4):  # b1 == b2: keys in either slot of the one row
        add(same_h, 80 + i, i % 2, i % 2, 1 + i % 2)
    # the empty-slot shadow: tag 0 and spare bits 0 match an all-zero slot
    # of b1 (value 0); one such key lives in b2, one is in no row
    for i in range(4):
        b1 = int(rng.integers(0, 1 << lb))
        while fused[b1].any():
            b1 = int(rng.integers(0, 1 << lb))
        h = np.uint64(b1 << (64 - lb))
        stored = i % 2 == 0 and put(h, 90 + i, 1, 1)
        qs.append(h), want.append(90 + i if stored else 0), row.append(2 if stored else 0)
    add(rand_h, 0, 0, 0, 0)  # stored with value 0: row 1 matches and yields 0
    for _ in range(40):
        qs.append(rand_h()), want.append(0), row.append(0)
    return fused, np.array(qs, np.uint64), np.array(want), np.array(row)


def test_probe_fused_edges_match_jax():
    """probe_fused_plain and the kernel's two-round mirror against the JAX
    package's _probe_fused on hand-laid rows: keys in their second choice,
    pinned first-tag-0 keys, b1 == b2, the empty-slot shadow (with and
    without the key in b2), a row-1 match of value 0, junk."""
    lb = 8
    fused, h, want, row = _edge_table(lb)
    j_found, j_val = (np.asarray(a) for a in jax_probe_fused(jnp.asarray(fused), jnp.asarray(h), lb))
    plane, ht = T(fused.view(np.int32)), T(h.view(np.int64))
    found, val = probe_fused_plain(plane, ht, lb)
    np.testing.assert_array_equal(found.numpy(), j_found)
    np.testing.assert_array_equal(val.numpy(), j_val.astype(np.int64))
    np.testing.assert_array_equal(val.numpy(), want)
    rval, answered = probe_fused_rounds(plane, ht, lb)
    np.testing.assert_array_equal(rval.numpy(), j_val.astype(np.int64))
    np.testing.assert_array_equal(answered.numpy(), row)
    valid = np.arange(len(h)) % 7 != 3
    got = hash_lookup_kmers((plane,), ht, T(valid)).numpy()
    np.testing.assert_array_equal(got, np.where(valid, j_val, 0).astype(np.int32))
    assert j_found[want == 0].any()  # the shadow and the value-0 match are found with value 0


def test_probe_fused_rounds_on_a_build():
    """On a real fused build at the layout's default width (load <= 0.6):
    every key answers, most from their first row (the cuckoo starts each
    key in b1), the rest from their second; the two-round value equals the
    JAX probe's on keys and junk."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 62, 40_000, dtype=np.uint64))
    vals = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    host, lb = build_hash_table(keys, vals, layout="fused")
    h = murmur3_finalizer(np.concatenate([keys, rng.integers(0, 1 << 62, 4000, dtype=np.uint64)]))
    _, j_val = jax_probe_fused(jnp.asarray(host[0]), jnp.asarray(h), lb)
    val, answered = probe_fused_rounds(T(host[0].view(np.int32)), T(h.view(np.int64)), lb)
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val).astype(np.int64))
    a = answered.numpy()
    n = len(keys)
    np.testing.assert_array_equal(val.numpy()[:n], vals)
    assert (a[:n] > 0).all() and (a[n:] == 0).all()
    assert 0.5 < (a[:n] == 1).mean() < 1 and (a[:n] == 2).any()
