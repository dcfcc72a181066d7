"""The port's tree resolution (krakenuniq_tpu_torch.taxonomy.resolve) against
the JAX package: the plain all-pairs, event-sort and counting score forms
against the Pallas kernel (interpret mode) and the JAX sort form, exactly as
tests/test_resolve_pallas.py runs them, and `resolve_reads` against the JAX
`resolve_reads` on the golden pool tables and on a disconnected taxonomy."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.taxonomy import resolve as JR
from krakenuniq_tpu_torch.db.device_db import compute_vals_dense
from krakenuniq_tpu_torch.db.pool import build_value_pool
from krakenuniq_tpu_torch.formats import read_kdb
from krakenuniq_tpu_torch.taxonomy import Taxonomy
from krakenuniq_tpu_torch.taxonomy import resolve as TR

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _masked(s, hit):
    return np.where(hit, np.asarray(s), 0)


@pytest.mark.parametrize("trial,b,w", [(0, 67, 30), (1, 64, 130), (2, 5, 7)])
def test_scores_match_pallas_and_sort(trial, b, w):
    rng = np.random.default_rng(trial)
    tins = rng.integers(0, 5000, size=(b, w)).astype(np.int32)
    touts = (tins + rng.integers(1, 2500, size=(b, w))).astype(np.int32)
    hit = rng.random((b, w)) < 0.7
    jt, jo, jh = jnp.asarray(tins), jnp.asarray(touts), jnp.asarray(hit)
    want = _masked(JR._scores_pallas(jt, jo, jh, interpret=True), hit)
    np.testing.assert_array_equal(want, _masked(JR._scores_sort(jt, jo, jh), hit))
    tt, to, th = torch.from_numpy(tins), torch.from_numpy(touts), torch.from_numpy(hit)
    np.testing.assert_array_equal(_masked(TR._scores_plain(tt, to, th), hit), want)
    np.testing.assert_array_equal(_masked(TR._scores_sort(tt, to, th), hit), want)
    np.testing.assert_array_equal(_masked(TR.scores(tt, to, th), hit), want)


def test_scores_all_miss():
    b, w = 8, 33
    z = np.zeros((b, w), np.int32)
    hm = np.zeros((b, w), bool)
    want = _masked(JR._scores_pallas(jnp.asarray(z), jnp.asarray(z), jnp.asarray(hm), interpret=True), hm)
    for fn in (TR._scores_plain, TR._scores_sort, TR._scores_count):
        got = fn(torch.from_numpy(z), torch.from_numpy(z), torch.from_numpy(hm))
        np.testing.assert_array_equal(_masked(got, hm), want)
        assert (_masked(got, hm) == 0).all()


def _score_case(trial, b, w, hit_rate=0.7):
    rng = np.random.default_rng(trial)
    tins = rng.integers(0, 5000, size=(b, w)).astype(np.int32)
    touts = (tins + rng.integers(1, 2500, size=(b, w))).astype(np.int32)
    return tins, touts, rng.random((b, w)) < hit_rate


@pytest.mark.parametrize(
    "trial,b,w,hit_rate",
    [(0, 67, 30, 0.7), (1, 64, 130, 0.7), (2, 5, 7, 0.7), (3, 8, 33, 0.0), (4, 3, 1030, 0.7)],
    ids=["67x30", "64x130", "5x7", "all-miss", "W>1024"],
)
def test_scores_count_matches_pallas_and_sort(trial, b, w, hit_rate):
    """The kernel's counting form (sorted tins/touts, two searches per
    query, 0 at non-hit lanes) equals the Pallas kernel and the JAX sort
    form at every hit lane and is 0 elsewhere."""
    tins, touts, hit = _score_case(trial, b, w, hit_rate)
    jt, jo, jh = jnp.asarray(tins), jnp.asarray(touts), jnp.asarray(hit)
    want = _masked(JR._scores_pallas(jt, jo, jh, interpret=True), hit)
    np.testing.assert_array_equal(want, _masked(JR._scores_sort(jt, jo, jh), hit))
    got = TR._scores_count(torch.from_numpy(tins), torch.from_numpy(touts), torch.from_numpy(hit)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scores_strided_halves_of_io_gather():
    """The CPU path of `scores` takes the two strided halves of the
    [B, W, 2] gather that resolve_reads hands it, as the kernel does."""
    tins, touts, hit = _score_case(5, 16, 40)
    io = torch.from_numpy(np.stack([tins, touts], axis=2))
    got = TR.scores(io[..., 0], io[..., 1], torch.from_numpy(hit)).numpy()
    want = TR._scores_count(torch.from_numpy(tins), torch.from_numpy(touts), torch.from_numpy(hit)).numpy()
    np.testing.assert_array_equal(got, want)


def _resolve_both(taxa, hit, tin, tout, parent, root, depth):
    want = np.asarray(
        JR.resolve_reads(
            jnp.asarray(taxa), jnp.asarray(hit), jnp.asarray(tin), jnp.asarray(tout),
            jnp.asarray(parent), jnp.int32(root), depth,
        )
    )
    t = torch.from_numpy
    for plain in (False, True):
        io = torch.stack([t(np.asarray(tin, np.int32)), t(np.asarray(tout, np.int32))], dim=1)
        got = TR.resolve_reads(t(taxa), t(hit), io, t(parent), root, depth, plain=plain).numpy()
        np.testing.assert_array_equal(got, want)
    return want


def test_resolve_reads_golden_pool(rng):
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    _, _, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    pool = build_value_pool([compute_vals_dense(vals, tax)], tax)
    b, w = 96, 40
    taxa = rng.integers(0, pool.size, size=(b, w)).astype(np.int32)
    hit = (rng.random((b, w)) < 0.5) & (taxa != 0)
    # ties: two candidates with equal counts and nothing else
    for i in range(0, 16):
        a, c = rng.choice(np.arange(1, pool.size), 2, replace=False)
        taxa[i] = np.where(np.arange(w) % 2 == 0, a, c)
        hit[i] = np.arange(w) < 2 * (i % 5 + 1)
    hit[16:20] = False  # empty reads
    want = _resolve_both(taxa, hit, pool.tin, pool.tout, pool.parent, pool.root, pool.max_depth)
    assert (want[16:20] == 0).all() and (want[20:] != 0).any()


def test_resolve_reads_disconnected_ties():
    # taxon 50's parent 99 is missing: it forms its own component, so a tie
    # between it and a rooted taxon has no common ancestor -> the root
    taxids = [1, 2, 3, 4, 50]
    parents = [1, 1, 2, 2, 99]
    tax = Taxonomy._build(taxids, parents, ["n"] * 5, ["no rank"] * 5, [0] * 5, [0] * 5, False)
    d = lambda x: int(tax.dense_index(np.asarray([x], np.uint32))[0])
    root = d(1)
    taxa = np.zeros((4, 6), np.int32)
    hit = np.zeros((4, 6), bool)
    taxa[0, :2] = [d(3), d(50)]  # disconnected tie -> root
    taxa[1, :2] = [d(3), d(4)]  # connected tie -> LCA = taxid 2
    taxa[2, :3] = [d(50), d(50), d(3)]  # 50 wins outright
    hit[0, :2] = hit[1, :2] = hit[2, :3] = True  # row 3: empty read
    want = _resolve_both(taxa, hit, tax.tin, tax.tout, tax.parent, root, tax.max_depth)
    np.testing.assert_array_equal(want, [root, d(2), d(50), 0])
