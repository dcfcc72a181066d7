"""The port's table caches (krakenuniq_tpu_torch.db.ht_cache) on the CPU,
after tests/test_hash_lookup.py::test_ht_disk_cache and
tests/test_outofcore.py::test_ooc_cache_roundtrip: a load writes
`<kdb>.ht_torch` / `<kdb>.ht_dense_torch` / `<kdb>.htc_torch` and the next
load reads it (no build, the same planes); a touched taxDB, another value
pool, a corrupt file, another budget or chunk_multiple rebuild; a failed
write is not fatal; writes go through temporary names of their own; and the
JAX package's cache files beside the database stay byte-identical and are
never read. Every test works on copies of the golden databases in
tmp_path."""

import io
import os
import shutil

import numpy as np
import pytest

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.db import chunked, ht_cache
from krakenuniq_tpu_torch.db.device_db import load_database_dir
from krakenuniq_tpu_torch.db.pool import build_value_pool
from krakenuniq_tpu_torch.formats import read_kdb
from krakenuniq_tpu_torch.taxonomy import Taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
JAX_CACHES = ("database.kdb.ht", "database.kdb.ht_dense", "database.kdb.htc", "database.kdb.ht1",
              "database.kdb.ht2", "database.kdb.ht4", "database.kdb.ht8")


def _copy(tmp_path, d=".", jax_caches=False):
    dst = tmp_path / d
    os.makedirs(dst, exist_ok=True)
    names = ["database.kdb", "database.idx", "taxDB", "database.kdb.counts"]
    if jax_caches:
        names += [n for n in JAX_CACHES if os.path.exists(os.path.join(DATA, d, n))]
    for name in names:
        shutil.copy(os.path.join(DATA, d, name), dst / name)
    return str(dst)


def _load(d, pool="auto"):
    return load_database_dir(d, device="cpu", pool=pool)[0]


def _same_planes(a, b):
    return len(a) == len(b) and all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(a, b))


@pytest.mark.parametrize("pooled", [True, False])
def test_cache_miss_then_hit(tmp_path, pooled):
    d = _copy(tmp_path)
    pool = "auto" if pooled else None
    name = "database.kdb.ht_torch" if pooled else "database.kdb.ht_dense_torch"
    cold = _load(d, pool)
    assert cold.timings["cache"] == "miss" and "build" in cold.timings
    assert os.path.exists(os.path.join(d, name))
    assert (cold.pool is not None) == pooled
    warm = _load(d, pool)
    assert warm.timings["cache"] == "hit" and "build" not in warm.timings and "cache_read" in warm.timings
    assert _same_planes(warm.hash_table, cold.hash_table) and warm.hash_lb == cold.hash_lb
    other = "database.kdb.ht_dense_torch" if pooled else "database.kdb.ht_torch"
    assert not os.path.exists(os.path.join(d, other))


def test_cache_stale_when_taxdb_touched(tmp_path):
    d = _copy(tmp_path)
    _load(d)
    st = os.stat(os.path.join(d, "taxDB"))
    os.utime(os.path.join(d, "taxDB"), ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    again = _load(d)
    assert again.timings["cache"] == "miss" and "build" in again.timings
    assert _load(d).timings["cache"] == "hit"


def test_cache_pool_rows_mismatch_rebuilds(tmp_path):
    """A table of the joint pool of db_bact + db_viral is another value space
    than db_bact's own pool: the cache written under one is a miss for the
    other."""
    bact, viral = _copy(tmp_path, "db_bact"), _copy(tmp_path, "db_viral")
    tax = Taxonomy.from_taxdb_file(os.path.join(bact, "taxDB"))
    joint = build_value_pool(
        [tax.dense_index(read_kdb(os.path.join(x, "database.kdb"))[2]) for x in (bact, viral)], tax
    )
    first = load_database_dir(bact, taxonomy=tax, device="cpu", pool=joint)[0]
    assert first.timings["cache"] == "miss" and first.pool is joint
    own = _load(bact)
    assert own.timings["cache"] == "miss" and not np.array_equal(own.pool.rows, joint.rows)
    assert _load(bact).timings["cache"] == "hit"


def test_cache_corrupt_file_rebuilds(tmp_path):
    d = _copy(tmp_path)
    path = os.path.join(d, "database.kdb.ht_torch")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not an npz")
    db = _load(d)
    assert db.timings["cache"] == "miss"
    assert ht_cache.load_ht_cache(path, os.path.join(d, "database.kdb"), os.path.join(d, "taxDB")) is not None
    assert _load(d).timings["cache"] == "hit"


def test_cache_write_failure_is_not_fatal(tmp_path, monkeypatch):
    """A write that fails (a read-only database directory) leaves the load
    whole and no file behind, temporary or not."""
    d = _copy(tmp_path)

    def refuse(src, dst):
        raise PermissionError(13, "read-only file system", dst)

    monkeypatch.setattr(ht_cache.os, "replace", refuse)
    db = _load(d)
    assert db.timings["cache"] == "write_failed" and db.hash_table is not None
    assert sorted(os.listdir(d)) == ["database.idx", "database.kdb", "database.kdb.counts", "taxDB"]


def test_cache_writes_through_unique_temporary_names(tmp_path, monkeypatch):
    """Each write goes to a temporary name of its own (the process id and a
    random suffix), renamed over the cache: two writers of one file never
    share a temporary."""
    d = _copy(tmp_path)
    seen = []
    real = ht_cache.os.replace
    monkeypatch.setattr(ht_cache.os, "replace", lambda src, dst: seen.append(src) or real(src, dst))
    kdb, taxdb = os.path.join(d, "database.kdb"), os.path.join(d, "taxDB")
    path = os.path.join(d, "database.kdb.ht_torch")
    planes = (np.arange(64, dtype=np.uint32).reshape(16, 4),)
    assert ht_cache.save_ht_cache(path, planes, 4, kdb, taxdb)
    assert ht_cache.save_ht_cache(path, planes, 4, kdb, taxdb)
    assert len(set(seen)) == 2 and all(f".{os.getpid()}." in s for s in seen)
    got = ht_cache.load_ht_cache(path, kdb, taxdb)
    assert got[1] == 4 and np.array_equal(got[0][0], planes[0])
    assert sorted(os.listdir(d)) == sorted(["database.idx", "database.kdb", "database.kdb.counts", "taxDB",
                                           "database.kdb.ht_torch"])


class _Reads:
    """Records every file the cache module opens through np.load."""

    def __init__(self, monkeypatch):
        self.paths = []
        real = ht_cache.np.load
        monkeypatch.setattr(ht_cache.np, "load", lambda p, *a, **k: self.paths.append(str(p)) or real(p, *a, **k))


@pytest.mark.parametrize("mode", ["resident", "dense", "out-of-core"])
def test_jax_cache_files_untouched_and_unread(tmp_path, monkeypatch, mode):
    """The JAX package's .ht/.ht_dense/.htc/.htN files beside the database
    (here the golden directory's own) stay byte-identical, are never
    opened by the port's cache, and the port's own file is the one that
    appears; the run gives the golden bytes."""
    d = _copy(tmp_path, jax_caches=True)
    before = {n: (tmp_path / n).read_bytes() for n in os.listdir(d)}
    assert {"database.kdb.ht", "database.kdb.htc"} <= set(before)
    reads = _Reads(monkeypatch)
    opts = {"resident": {}, "dense": {"value_pool": False}, "out-of-core": {"preload_size": 40_000}}[mode]
    for _ in range(2):  # the second load reads the port's cache
        c = Classifier([d], ClassifyOptions(print_progress=False, device="cpu", **opts))
        kraken = io.StringIO()
        c.run([os.path.join(DATA, "reads.fa")], kraken_fh=kraken)
        with open(os.path.join(DATA, "kraken.out")) as f:
            assert kraken.getvalue() == f.read()
    mine = {"resident": "database.kdb.ht_torch", "dense": "database.kdb.ht_dense_torch",
            "out-of-core": "database.kdb.htc_torch"}[mode]
    timings = c._ooc[0].timings if mode == "out-of-core" else c.dbs[0].timings
    assert timings["cache"] == "hit"
    assert sorted(os.listdir(d)) == sorted([*before, mine])
    assert all((tmp_path / n).read_bytes() == b for n, b in before.items())
    assert reads.paths and all(p.endswith("_torch") for p in reads.paths)


def _chunk_load(d, budget, pool="auto"):
    tax = Taxonomy.from_taxdb_file(os.path.join(d, "taxDB"))
    return chunked.load_chunked_db(d, budget, tax, pool=pool)


def test_chunk_cache_roundtrip(tmp_path):
    d = _copy(tmp_path)
    cold = _chunk_load(d, 30_000)
    assert cold.timings["cache"] == "miss" and cold.n_chunks >= 3
    warm = _chunk_load(d, 30_000)
    assert warm.timings["cache"] == "hit" and "build" not in warm.timings
    assert (warm.lb, warm.bounds, warm.key_ct, warm.k, warm.nt) == (cold.lb, cold.bounds, cold.key_ct, cold.k,
                                                                    cold.nt)
    assert all(_same_planes(a, b) for a, b in zip(warm.chunk_planes, cold.chunk_planes))
    assert warm.n_chunks == cold.n_chunks and np.array_equal(warm.vals_dense, cold.vals_dense)
    assert np.array_equal(warm.pool.rows, cold.pool.rows)


@pytest.mark.parametrize("change", ["budget", "chunk_multiple", "pool"])
def test_chunk_cache_rebuilds_on_a_changed_key(tmp_path, change):
    """A chunk cache written under one budget, chunk_multiple (a file whose
    planner cut to a multiple of 4; the port plans with 1) or value pool
    is a miss under another: the set is rebuilt and the cache rewritten,
    after which the new key hits."""
    d = _copy(tmp_path)
    assert _chunk_load(d, 30_000).timings["cache"] == "miss"
    kw = {"budget": 30_000, **{"budget": {"budget": 20_000}, "chunk_multiple": {},
                               "pool": {"pool": None}}[change]}
    if change == "chunk_multiple":
        path, kdb, taxdb = (os.path.join(d, n) for n in ("database.kdb.htc_torch", "database.kdb", "taxDB"))
        planes, lb, extra = ht_cache.load_ht_cache(path, kdb, taxdb, ht_cache.CHUNK_SOURCES)
        assert extra["chunk_multiple"] == 1
        assert ht_cache.save_ht_cache(path, planes, lb, kdb, taxdb, extra={**extra, "chunk_multiple": 4},
                                      sources=ht_cache.CHUNK_SOURCES)
    again = _chunk_load(d, **kw)
    assert again.timings["cache"] == "miss"
    assert _chunk_load(d, **kw).timings["cache"] == "hit"
    if change != "chunk_multiple":
        assert _chunk_load(d, 30_000).timings["cache"] == "miss"  # one cache file: the last key wins


@pytest.mark.parametrize("kind", ["resident", "out-of-core"])
def test_cache_follows_the_code(tmp_path, monkeypatch, kind):
    """The cache key holds a digest of the sources that decide the planes'
    bytes: an edit to one of them (here a byte appended to db/pool.py, or to
    db/chunked.py for the chunks) is a miss without a _VERSION bump, and the
    rebuilt file hits under the edited code."""
    d = _copy(tmp_path)
    sources, edited = ((ht_cache.TABLE_SOURCES, "db/pool.py") if kind == "resident"
                       else (ht_cache.CHUNK_SOURCES, "db/chunked.py"))
    load = (lambda: _load(d).timings) if kind == "resident" else (lambda: _chunk_load(d, 30_000).timings)
    assert load()["cache"] == "miss"
    assert load()["cache"] == "hit"
    for name in ("same", "edited"):
        root = tmp_path / name
        for rel in sources:
            os.makedirs(root / os.path.dirname(rel), exist_ok=True)
            shutil.copy(os.path.join(ht_cache._PKG, rel), root / rel)
    with open(tmp_path / "edited" / edited, "a") as fh:
        fh.write("\n")
    monkeypatch.setattr(ht_cache, "_PKG", str(tmp_path / "same"))
    assert load()["cache"] == "hit"  # the same code at another path
    monkeypatch.setattr(ht_cache, "_PKG", str(tmp_path / "edited"))
    assert load()["cache"] == "miss"
    assert load()["cache"] == "hit"
