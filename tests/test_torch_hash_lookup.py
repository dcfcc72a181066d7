"""The port's CHD table: its host build (krakenuniq_tpu_torch.db.hash_table)
answers every key with its value and misses junk, and its plain probe equals
the JAX package's `_probe_chd` on the JAX package's own host planes,
loaded through `device_db_from_host`."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.db.hash_table import build_hash_table as jax_build_hash_table
from krakenuniq_tpu.lookup.hash_lookup import _probe_chd as jax_probe_chd
from krakenuniq_tpu.lookup.hash_lookup import hash_lookup_kmers as jax_hash_lookup_kmers
from krakenuniq_tpu_torch.db.device_db import device_db_from_host, load_database_dir
from krakenuniq_tpu_torch.db.hash_table import C2, GOLDEN, build_hash_table
from krakenuniq_tpu_torch.formats import read_kdb
from krakenuniq_tpu_torch.lookup.hash_lookup import (
    hash_lookup_kmers,
    hash_lookup_plain,
    probe_chd_plain,
)
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _lookup(db, keys, valid=None):
    h = torch.from_numpy(murmur3_finalizer(keys).view(np.int64))
    v = torch.ones(len(keys), dtype=torch.bool) if valid is None else torch.from_numpy(valid)
    return hash_lookup_kmers(db.hash_table, h, v).numpy()


def _junk(rng, keys, n=2000):
    j = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    return j[~np.isin(j, keys)]


@pytest.mark.parametrize("n", [10, 1000, 50000])
def test_port_build_random_keys(rng, n):
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    vals = rng.integers(1, 1 << 16, size=len(keys)).astype(np.int32)
    host, lr = build_hash_table(keys, vals)
    assert host[1].shape == (1 << lr, 4) and host[0].shape[1] == 4
    db = device_db_from_host(host, lr, None, k=31, nt=12, device="cpu")
    np.testing.assert_array_equal(_lookup(db, keys), vals)
    assert (_lookup(db, _junk(rng, keys)) == 0).all()
    assert (_lookup(db, keys, np.zeros(len(keys), bool)) == 0).all()


def test_port_build_golden_db(rng):
    db, tax = load_database_dir(DATA, device="cpu")
    _, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    want = db.pool.pool_index(tax.dense_index(vals))
    np.testing.assert_array_equal(_lookup(db, keys), want)
    assert (_lookup(db, _junk(rng, keys)) == 0).all()


@pytest.mark.parametrize("n", [1000, 30000])
def test_probe_matches_jax_on_jax_planes(rng, n):
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    vals_dense = rng.integers(1, 1 << 16, size=len(keys)).astype(np.int32)
    _, lr, host = jax_build_hash_table(
        keys, vals_dense.astype(np.uint32), vals_dense, to_device=False, keep_host=True
    )
    db = device_db_from_host(host, lr, None, k=31, nt=12, device="cpu")
    h = murmur3_finalizer(np.concatenate([keys, _junk(rng, keys)]))
    # r == 0 queries (low 64-lr hash bits zero) match empty all-zero slots
    r0 = rng.integers(0, 1 << lr, size=64, dtype=np.uint64) << np.uint64(64 - lr)
    h = np.concatenate([h, r0, np.zeros(1, np.uint64)])
    found, val = probe_chd_plain(*db.hash_table, torch.from_numpy(h.view(np.int64)), lr)
    j_found, j_val = jax_probe_chd(jnp.asarray(host[0]), jnp.asarray(host[1]), jnp.asarray(h), lr)
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val).astype(np.int64))
    np.testing.assert_array_equal(val.numpy()[: len(keys)], vals_dense)
    # the r == 0 queries hit empty slots (found) with value 0 (a miss)
    assert found.numpy()[-65:].any() and (val.numpy()[-65:] == 0).all()


def test_lookup_refuses_other_layouts():
    """Planes of no layout, and two-level planes whose confirm plane is not
    twice the tag plane, are refused."""
    h, valid = torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool)
    plane = torch.zeros((16, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="confirm"):
        hash_lookup_kmers((plane, plane), h, valid)
    with pytest.raises(ValueError, match="no table layout"):
        hash_lookup_kmers((torch.zeros((16, 3), dtype=torch.int32), plane), h, valid)


def test_demo_db_matches_jax_and_probes():
    """The port's synthetic database (utils/demo.py, which dedups ballast
    by sort instead of np.unique) equals the JAX package's, and its CHD
    table answers every key."""
    from krakenuniq_tpu.utils.demo import make_demo_db as jax_make_demo_db
    from krakenuniq_tpu_torch.utils.demo import make_demo_db

    kw = dict(n_species=6, genome_len=600, k=31, nt=9, pad_nodes=50, ballast_keys=5000)
    keys, vals, offsets, tax, genomes = make_demo_db(**kw)
    j_keys, j_vals, j_offsets, j_tax, j_genomes = jax_make_demo_db(**kw)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_array_equal(vals, j_vals)
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(tax.taxids, j_tax.taxids)
    assert genomes == j_genomes
    host, lr = build_hash_table(keys, vals.astype(np.int32))
    db = device_db_from_host(host, lr, None, k=31, nt=9, device="cpu")
    np.testing.assert_array_equal(_lookup(db, keys), vals.astype(np.int32))


# ------------------------------------------------------------- edge inputs


def _chd_row_of(disp, h, lr, lg):
    """(unwrapped row sum p + d0 + d1*q, row, r) of uint64 hashes `h` for a
    uint32 displacement plane `disp` [2^lg], as db/hash_table.py places."""
    r = h & np.uint64((1 << (64 - lr)) - 1)
    g = (r * GOLDEN) >> np.uint64(64 - lg)
    q = (r * C2) >> np.uint64(64 - lr)
    d = disp[g.astype(np.int64)].astype(np.uint64)
    raw = (h >> np.uint64(64 - lr)) + (d & np.uint64(0xFFFF)) + (d >> np.uint64(16)) * q
    return raw, (raw & np.uint64((1 << lr) - 1)).astype(np.int64), r


def _plant(disp, rows, h, lr, lg, vals):
    """Store each hash in slot 0 of its row with its value (later ones win)."""
    _, row, r = _chd_row_of(disp, h, lr, lg)
    rows[row, 0] = (r >> np.uint64(32 - lr)).astype(np.uint32)
    lo = (r & np.uint64((1 << (32 - lr)) - 1)) << np.uint64(lr)
    rows[row, 1] = (lo | vals.astype(np.uint64)).astype(np.uint32)


EDGE_PROBES = ["r0_empty", "all_invalid", "lr4", "wrap"]


@pytest.mark.parametrize("case", EDGE_PROBES)
def test_probe_edge_cases_match_jax(case):
    """hash_lookup_plain (and probe_chd_plain's found flags) against the JAX
    package's hash_lookup_kmers / _probe_chd on random planes: queries with
    r == 0 against empty slots, every lane invalid, the smallest table
    (lr = 4), and displacements large enough that p + d0 + d1*q wraps."""
    rng = np.random.default_rng(EDGE_PROBES.index(case))
    lr, lg = (4, 4) if case == "lr4" else (12, 10)
    n = 3000
    disp = rng.integers(0, 1 << 32, size=1 << lg, dtype=np.uint64).astype(np.uint32)
    if case == "wrap":
        disp |= np.uint32(0xFF00FF00)
    rows = rng.integers(0, 1 << 32, size=(1 << lr, 4), dtype=np.uint64).astype(np.uint32)
    h = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    if case == "r0_empty":
        rows[::2] = 0  # every other row empty
        h = (h >> np.uint64(64 - lr)) << np.uint64(64 - lr)  # r == 0
    else:
        _plant(disp, rows, h[: n // 2], lr, lg, rng.integers(1, 1 << lr, size=n // 2))
    valid = np.zeros(n, bool) if case == "all_invalid" else rng.random(n) < 0.9
    raw, _, _ = _chd_row_of(disp, h, lr, lg)
    if case == "wrap":
        assert (raw >= np.uint64(1 << lr)).mean() > 0.9, "the row sums should wrap"

    disp4 = disp.reshape(-1, 4)
    planes = (torch.from_numpy(disp4.view(np.int32)), torch.from_numpy(rows.view(np.int32)))
    ht = torch.from_numpy(h.view(np.int64))
    got = hash_lookup_plain(planes, ht, torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_hash_lookup_kmers(
        (jnp.asarray(disp4), jnp.asarray(rows)), jnp.asarray(h), jnp.asarray(valid), lr
    ))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    found, val = probe_chd_plain(*planes, ht, lr)
    j_found, j_val = jax_probe_chd(jnp.asarray(disp4), jnp.asarray(rows), jnp.asarray(h), lr)
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val).astype(np.int64))
    if case == "r0_empty":
        assert found.numpy().any() and (got == 0).all()
    elif case == "all_invalid":
        assert found.numpy().any() and (got == 0).all()
    else:
        hits = (got[: n // 2][valid[: n // 2]] != 0).sum()
        assert hits > 0.3 * min(n // 2, 1 << lr), "planted keys should hit"


def test_lookup_refuses_planes_not_powers_of_two():
    """The wrapper reads lr and lg from the plane shapes, so each plane must
    hold a power of two of words or rows."""
    h, v = torch.zeros(3, dtype=torch.int64), torch.ones(3, dtype=torch.bool)
    ok_disp, ok_rows = torch.zeros((4, 4), dtype=torch.int32), torch.zeros((16, 4), dtype=torch.int32)
    for planes in ((torch.zeros((3, 4), dtype=torch.int32), ok_rows),
                   (ok_disp, torch.zeros((24, 4), dtype=torch.int32))):
        with pytest.raises(ValueError, match="powers of two"):
            hash_lookup_kmers(planes, h, v)
    assert (hash_lookup_kmers((ok_disp, ok_rows), h, v).numpy() == 0).all()
