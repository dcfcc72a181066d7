"""The redesigned raw two-level probe (`rows_probe`, `rows_probe_acc`) on the
CPU against the JAX package, with exact equality.

`probe_rows_rounds` is the kernel's algorithm in plain torch: the first
bucket's tag row and both its confirm rows, then the second bucket only
where no slot of the first screens and the buckets differ. It must equal the
JAX package's `_probe_rows` (value where found, 0 elsewhere), and so must
`probe_rows_plain` and `hash_lookup_kmers` (the plain version on CPU
tensors), on a table that both packages' `build_hash_table(store_raw=True)`
build from one seeded key set, on planted edge cases (coinciding buckets, a
false first-bucket screen over a key stored in its second bucket, zero-tag
keys behind an empty slot 0) and at lb = 30, where bucket and slot indices
reach 2^30 and 2^31 - 1: there the planes are kept sparse (only the rows the
queries touch), for both packages' gathers. The split it returns (first
bucket, second, neither) adds up to the valid lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.db.hash_table import build_hash_table as jax_build_hash_table
from krakenuniq_tpu.lookup import hash_lookup as jax_hash_lookup
from krakenuniq_tpu_torch.db.hash_table import GOLDEN, build_hash_table
from krakenuniq_tpu_torch.lookup.hash_lookup import (
    hash_lookup_kmers,
    probe_rows_plain,
    probe_rows_rounds,
)
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

T = torch.from_numpy


def _tag(x, lb):
    return ((x << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)


def _lo(x):
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _jax_values(ptags, confirm, q, lb):
    """The JAX package's _probe_rows as one value word per query, 0 where
    it finds none."""
    found, val = jax_hash_lookup._probe_rows(jnp.asarray(ptags), jnp.asarray(confirm), jnp.asarray(q), lb)
    return np.where(np.asarray(found), np.asarray(val), 0).astype(np.uint32)


def _port(ptags, confirm, q, lb):
    """(probe_rows_rounds' values, its split, probe_rows_plain's values) as
    uint32 and int64 numpy arrays."""
    planes = (T(ptags.view(np.int32)), T(confirm.view(np.int32)))
    h = T(q.view(np.int64))
    val, where = probe_rows_rounds(*planes, h, lb)
    found, pval = probe_rows_plain(*planes, h, lb)
    plain = torch.where(found, pval, 0)
    return val.numpy().astype(np.uint32), where.numpy(), plain.numpy().astype(np.uint32)


def _check_split(where, valid):
    counts = [int(((where == s) & valid).sum()) for s in (1, 2, 0)]
    assert sum(counts) == int(valid.sum())
    return counts


@pytest.mark.parametrize("n_keys,seed", [(2000, 1), (30_000, 2), (100_000, 3)])
def test_rounds_on_both_builds(n_keys, seed):
    """Both packages build the same raw table from one key set; every key
    probes back through the rounds, the plain probe and hash_lookup_kmers,
    equal to the JAX probe on the keys and on misses, and most keys screen
    in their first bucket (the build starts every key there)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, size=n_keys, dtype=np.uint64))
    vals = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    planes, lb = build_hash_table(keys, vals, store_raw=True)
    _, j_lb, j_planes = jax_build_hash_table(keys, vals, np.zeros(len(keys), np.int32), store_raw=True,
                                             to_device=False, keep_host=True)
    assert lb == j_lb
    for got, want in zip(planes, j_planes):
        np.testing.assert_array_equal(got, want)
    ptags, confirm = (np.asarray(p, np.uint32) for p in planes)
    q = np.concatenate([murmur3_finalizer(keys), rng.integers(0, 1 << 64, size=5000, dtype=np.uint64)])
    want = _jax_values(ptags, confirm, q, lb)
    val, where, plain = _port(ptags, confirm, q, lb)
    np.testing.assert_array_equal(val, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(want[: len(keys)], vals)
    valid = rng.random(len(q)) < 0.9
    got = hash_lookup_kmers((T(ptags.view(np.int32)), T(confirm.view(np.int32))), T(q.view(np.int64)),
                            T(valid))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.where(valid, want, 0))
    first, second, _ = _check_split(where[: len(keys)], np.ones(len(keys), bool))
    assert first + second == len(keys) and first > 0.6 * len(keys)
    _check_split(where, valid)


def _edge_planes(lb, seed):
    """Random raw planes with the probe's edge cases planted, and their
    queries by kind: keys in either bucket and slot, keys whose two buckets
    coincide (first-choice tags; and second-choice tags, which the probe
    never compares in a coinciding bucket), zero-tag keys stored in slot 1 behind an
    empty slot 0 (they miss: slot 0 screens first), keys stored in their
    second bucket behind a first bucket that screens them falsely (they
    miss), and random misses."""
    with np.errstate(over="ignore"):  # uint64 products wrap, as the hash's do
        rng = np.random.default_rng(seed)
        nb, shift = 1 << lb, np.uint64(64 - lb)
        ptags = rng.integers(0, 1 << 32, size=(nb, 2), dtype=np.uint64).astype(np.uint32)
        confirm = rng.integers(0, 1 << 32, size=(2 * nb, 2), dtype=np.uint64).astype(np.uint32)
        planted = rng.integers(0, 1 << 64, size=600, dtype=np.uint64)
        for i, x in enumerate(planted):
            choice, slot = i % 2, (i // 2) % 2
            xc = x * GOLDEN if choice else x
            b = int(xc >> shift)
            ptags[b, slot] = _tag(xc, lb)
            confirm[2 * b + slot] = (_lo(x), i + 1)
        cand = rng.integers(0, 1 << 64, size=1 << min(24, lb + 6), dtype=np.uint64)
        coincide = cand[(cand >> shift) == ((cand * GOLDEN) >> shift)]
        same, same2 = coincide[0::2][:40], coincide[1::2][:40]
        for i, x in enumerate(same):
            b = int(x >> shift)
            ptags[b, i % 2] = _tag(x, lb)
            confirm[2 * b + i % 2] = (_lo(x), 5000 + i)
        for i, x in enumerate(same2):  # the second-choice tag: never compared where the buckets coincide
            b = int(x >> shift)
            ptags[b, i % 2] = _tag(x * GOLDEN, lb)
            confirm[2 * b + i % 2] = (_lo(x), 5500 + i)
        zero_tag = (rng.integers(0, nb, size=64, dtype=np.uint64) << shift) | rng.integers(
            1, 1 << (32 - lb), size=64, dtype=np.uint64)
        for i, x in enumerate(zero_tag):
            b = int(x >> shift)
            ptags[b] = 0
            confirm[2 * b] = 0
            confirm[2 * b + 1] = (_lo(x), 6000 + i)
        screen = rng.integers(0, 1 << 64, size=64, dtype=np.uint64)
        for i, x in enumerate(screen):
            b1, b2 = int(x >> shift), int((x * GOLDEN) >> shift)
            ptags[b1, 0] = _tag(x, lb)
            confirm[2 * b1] = (_lo(x) ^ np.uint32(1), 7000 + i)
            ptags[b2, 1] = _tag(x * GOLDEN, lb)
            confirm[2 * b2 + 1] = (_lo(x), 8000 + i)
        misses = rng.integers(0, 1 << 64, size=600, dtype=np.uint64)
        kinds = {"planted": planted, "same": same, "same_second_tag": same2, "zero_tag": zero_tag,
                 "false_screen": screen, "misses": misses}
        return ptags, confirm, kinds


@pytest.mark.parametrize("lb", [8, 14, 20])
def test_rounds_edge_cases(lb):
    """The rounds, the plain probe and the JAX probe agree on every planted
    case, and, on planes wide enough that plants seldom overwrite each
    other, each case behaves as the first-screened-slot rule says: planted
    and coinciding-bucket keys are found where they screened, zero-tag keys
    and falsely screened keys miss at their first bucket."""
    ptags, confirm, kinds = _edge_planes(lb, 30 + lb)
    q = np.concatenate(list(kinds.values()))
    want = _jax_values(ptags, confirm, q, lb)
    val, where, plain = _port(ptags, confirm, q, lb)
    np.testing.assert_array_equal(val, want)
    np.testing.assert_array_equal(plain, want)
    _check_split(where, np.ones(len(q), bool))
    at = np.cumsum([0] + [len(v) for v in kinds.values()])
    part = dict(zip(kinds, (slice(a, b) for a, b in zip(at[:-1], at[1:]))))
    # one bucket: only first-choice tags compare
    assert len(kinds["same"]) > 0 and len(kinds["same_second_tag"]) > 0
    assert (where[part["same"]] != 2).all() and (where[part["same_second_tag"]] != 2).all()
    if lb >= 14:
        planted = where[part["planted"]]
        assert (planted[0::2] == 1).mean() > 0.95 and (planted[1::2] != 0).mean() > 0.95
        assert (val[part["same"]] >= 5000).mean() > 0.9 and (val[part["same_second_tag"]] == 0).mean() > 0.9
        for kind in ("zero_tag", "false_screen"):
            assert (where[part[kind]] == 1).mean() > 0.95 and (val[part[kind]] == 0).mean() > 0.95


class _SparseRows:
    """A raw plane of 2^lb (ptags) or 2^(lb+1) (confirm) rows of which only
    the listed rows exist: `rows[i]` is row `index[i]` (sorted). Indexing
    with a tensor gathers them (an index not listed raises)."""

    def __init__(self, index, rows):
        self.index, self.rows = torch.as_tensor(index, dtype=torch.int64), torch.as_tensor(rows)

    def _at(self, idx):
        pos = torch.searchsorted(self.index, idx).clamp(max=len(self.index) - 1)
        if not bool((self.index[pos] == idx).all()):
            raise IndexError("a row the probe reads is not in the sparse plane")
        return pos

    def __getitem__(self, idx):
        return self.rows[self._at(idx)]


class _SparseJnp:
    """The jnp module, its `take` gathering from (index, rows) pairs of the
    sparse planes by position: a row index the JAX probe forms wrongly (an
    int32 that wrapped, say) finds no row and reads 0xDEADBEEF words."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def take(a, idx, axis=0):
        if not isinstance(a, tuple):
            return jnp.take(a, idx, axis=axis)
        index, rows = a
        pos = jnp.clip(jnp.searchsorted(index, idx.astype(jnp.int64)), 0, len(index) - 1)
        hit = index[pos] == idx.astype(jnp.int64)
        return jnp.where(hit[:, None], rows[pos], jnp.uint32(0xDEADBEEF))


def _lb30_case(seed, lb=30):
    """Queries whose first bucket lies in the top 2^16 buckets of a
    2^30-bucket table (slot indices up to 2^31 - 1) and whose second bucket
    is anywhere; the rows they touch, random, with planted keys in either
    bucket and slot, zero-tag keys behind an empty slot 0 and keys in their
    second bucket behind a false screen in their first."""
    with np.errstate(over="ignore"):
        rng = np.random.default_rng(seed)
        shift = np.uint64(64 - lb)
        q = ((np.uint64((1 << lb) - 1) - rng.integers(0, 1 << 16, size=3000, dtype=np.uint64)) << shift) | \
            rng.integers(0, 1 << 34, size=3000, dtype=np.uint64)
        # zero tags (bits [2, 34) of h at lb = 30), a nonzero low word
        q[1500:1600] = (q[1500:1600] >> shift << shift) | rng.integers(1, 4, size=100, dtype=np.uint64)
        q[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)  # bucket 2^30 - 1 itself
        b1, b2 = q >> shift, (q * GOLDEN) >> shift
        buckets = np.unique(np.concatenate([b1, b2]))
        ptags = rng.integers(0, 1 << 32, size=(len(buckets), 2), dtype=np.uint64).astype(np.uint32)
        confirm = rng.integers(0, 1 << 32, size=(len(buckets), 2, 2), dtype=np.uint64).astype(np.uint32)
        row = lambda b: int(np.searchsorted(buckets, b))  # noqa: E731
        for i in range(0, 1500):
            choice, slot = i % 2, (i // 2) % 2
            x = q[i]
            xc = x * GOLDEN if choice else x
            r = row(xc >> shift)
            ptags[r, slot] = _tag(xc, lb)
            confirm[r, slot] = (_lo(x), i + 1)
        for x in q[1500:1600]:  # zero tags over an empty slot 0
            r = row(x >> shift)
            ptags[r, 0] = 0
            confirm[r, 0] = 0
        for i, x in enumerate(q[1600:1700]):  # a false screen at b1, the key in b2
            r1, r2 = row(x >> shift), row((x * GOLDEN) >> shift)
            ptags[r1, 1] = _tag(x, lb)
            confirm[r1, 1] = (_lo(x) ^ np.uint32(1), 9)
            ptags[r2, 0] = _tag(x * GOLDEN, lb)
            confirm[r2, 0] = (_lo(x), 10_000 + i)
        slots = np.stack([2 * buckets, 2 * buckets + 1], axis=1).reshape(-1)
        return q, (buckets, ptags), (slots, confirm.reshape(-1, 2))


@pytest.mark.parametrize("seed", [5, 6])
def test_rounds_at_lb30(seed, monkeypatch):
    """At lb = 30 (first buckets up to 2^30 - 1, slots up to 2^31 - 1) the
    rounds and the plain probe equal the JAX probe, each on sparse planes
    that hold only the rows the queries touch."""
    q, (buckets, ptags), (slots, confirm) = _lb30_case(seed)
    assert int(q.max() >> np.uint64(34)) == (1 << 30) - 1 and int(slots.max()) == (1 << 31) - 1
    monkeypatch.setattr(jax_hash_lookup, "jnp", _SparseJnp())
    found, jval = jax_hash_lookup._probe_rows((jnp.asarray(buckets.astype(np.int64)), jnp.asarray(ptags)),
                                              (jnp.asarray(slots.astype(np.int64)), jnp.asarray(confirm)),
                                              jnp.asarray(q), 30)
    monkeypatch.undo()
    want = np.where(np.asarray(found), np.asarray(jval), 0).astype(np.uint32)
    sp = (_SparseRows(buckets.astype(np.int64), T(ptags.view(np.int32))),
          _SparseRows(slots.astype(np.int64), T(confirm.view(np.int32))))
    h = T(q.view(np.int64))
    val, where = probe_rows_rounds(*sp, h, 30)
    ok, pval = probe_rows_plain(*sp, h, 30)
    np.testing.assert_array_equal(val.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(torch.where(ok, pval, 0).numpy().astype(np.uint32), want)
    first, second, _ = _check_split(where.numpy(), np.ones(len(q), bool))
    assert (want[:1500] > 0).mean() > 0.9 and first > 0 and second > 0
    assert (want[1500:1700] == 0).mean() > 0.9  # zero tags and false screens miss
