"""Minimizer-range database partitioning: out-of-core chunks and mesh shards.

The port's copy of krakenuniq_tpu/parallel/partition.py. The reference's
out-of-core chunking (`--preload-size`, krakendb.cpp:463-522) binary-searches
the largest minimizer range that fits a memory budget; db/chunked.py cuts the
minimizer space into N ranges of (near-)equal key count instead, and a mesh
(parallel/mesh.py) keeps N such ranges resident at once, one per rank along
its "db" axis. Each k-mer's minimizer lives in exactly one range, the
invariant the reference's chunk merge asserts (classify.cpp:447), so the
shards' words merge by a plain sum.

A mesh rank builds and holds only its own shard (`shard_hash_tables(...,
shards=[j])`, `load_sharded_db`); the stacked host planes of every shard
(`ShardedHashPlanes.stacked`) are what the shard cache holds and what the
JAX package's `[S, ...]` stacks are compared with.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from ..utils import trace


def partition_bins_equal_keys(offsets: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Cut bins [0, n_bins) into n_shards contiguous ranges with ~equal keys.

    offsets: (n_bins + 1) cumulative key counts. Returns [(bin_lo, bin_hi)).
    """
    offsets = np.asarray(offsets, dtype=np.uint64)
    n_bins = len(offsets) - 1
    total = int(offsets[-1])
    targets = [(total * i) // n_shards for i in range(1, n_shards)]
    cuts = [0]
    for t in targets:
        cut = int(np.searchsorted(offsets, t, side="left"))
        cut = max(cuts[-1], min(cut, n_bins))
        cuts.append(cut)
    cuts.append(n_bins)
    return [(cuts[i], cuts[i + 1]) for i in range(n_shards)]


@dataclasses.dataclass
class ShardedDBPlanes:
    """Stacked per-shard sorted planes (the binary search's), padded to one
    size (JAX partition.py:38-52)."""

    keys: np.ndarray  # uint64 [S, Nmax]; padding = all-ones sentinel
    vals: np.ndarray  # uint32 [S, Nmax]
    vals_dense: np.ndarray  # int32 [S, Nmax]
    offsets: np.ndarray  # int64 [S, Bmax + 1]; shard-relative, last value repeated
    bin_start: np.ndarray  # int64 [S]
    max_bin: int

    @property
    def n_shards(self) -> int:
        return self.keys.shape[0]

    def shard_planes(self, s: int) -> tuple:
        """Shard s's (keys, vals, vals_dense, offsets, bin_start) host planes."""
        return self.keys[s], self.vals[s], self.vals_dense[s], self.offsets[s], int(self.bin_start[s])


def shard_db_planes(
    keys: np.ndarray,
    vals: np.ndarray,
    vals_dense: np.ndarray,
    offsets: np.ndarray,
    n_shards: int,
) -> ShardedDBPlanes:
    bounds = partition_bins_equal_keys(offsets, n_shards)
    offsets = np.asarray(offsets, dtype=np.int64)
    key_slices = [(int(offsets[lo]), int(offsets[hi])) for lo, hi in bounds]
    n_max = max(e - s for s, e in key_slices)
    b_max = max(hi - lo for lo, hi in bounds)

    s_keys = np.full((n_shards, n_max), np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    s_vals = np.zeros((n_shards, n_max), dtype=np.uint32)
    s_vd = np.zeros((n_shards, n_max), dtype=np.int32)
    s_off = np.zeros((n_shards, b_max + 1), dtype=np.int64)
    s_start = np.zeros(n_shards, dtype=np.int64)
    max_bin = 0
    for i, ((blo, bhi), (klo, khi)) in enumerate(zip(bounds, key_slices)):
        n = khi - klo
        s_keys[i, :n] = keys[klo:khi]
        s_vals[i, :n] = vals[klo:khi]
        s_vd[i, :n] = vals_dense[klo:khi]
        rel = offsets[blo : bhi + 1] - offsets[blo]
        s_off[i, : len(rel)] = rel
        s_off[i, len(rel) :] = rel[-1] if len(rel) else 0  # padded bins are empty
        s_start[i] = blo
        if bhi > blo:
            max_bin = max(max_bin, int(np.diff(offsets[blo : bhi + 1]).max()))
    return ShardedDBPlanes(
        keys=s_keys, vals=s_vals, vals_dense=s_vd, offsets=s_off, bin_start=s_start, max_bin=max_bin
    )


@dataclasses.dataclass
class ShardedHashPlanes:
    """Per-shard hash tables (db/hash_table.py layouts) at one common width.

    planes[s] is shard s's plane tuple ((disp4, rows) of the CHD layout,
    (ptags, confirm) of a raw UID table): uint32 host arrays, or None for a
    shard this process did not build (a mesh rank builds its own only)."""

    planes: list
    lb: int
    bounds: list  # minimizer-bin range per shard
    store_raw: bool = False

    def shard_planes(self, s: int) -> tuple:
        """The plane tuple of one shard (probe-ready)."""
        return self.planes[s]

    @property
    def n_shards(self) -> int:
        return len(self.planes)

    def stacked(self) -> tuple:
        """Every shard's planes stacked on a leading shard axis: the JAX
        package's [S, ...] host stacks, and what the shard cache holds."""
        if any(p is None for p in self.planes):
            raise ValueError("stacked() needs every shard's planes")
        return tuple(np.stack(ps) for ps in zip(*self.planes))


def _common_lb(key_slices, vals_dense, store_raw: bool) -> int:
    """The smallest width every shard's table fits (JAX partition.py:
    133-143): the raw layout's load-0.6 buckets, or CHD's capacity and value
    width."""
    from ..db.hash_table import BUCKET_SLOTS, chd_min_lr

    if store_raw:
        return max(max(4, int(np.ceil(np.log2(max(khi - klo, 2) / (BUCKET_SLOTS * 0.6)))))
                   for klo, khi in key_slices)
    vmax = int(vals_dense.max()) if len(vals_dense) else 0
    return max(chd_min_lr(khi - klo, vmax) for klo, khi in key_slices)


def shard_hash_tables(
    keys: np.ndarray,
    vals: np.ndarray,
    vals_dense: np.ndarray,
    offsets: np.ndarray,
    n_shards: int,
    hash_sink: list | None = None,  # appended with (stacked host planes, lb, bounds)
    store_raw: bool = False,
    shards=None,
    any_failed=None,
    check=None,
    timings: dict | None = None,
) -> ShardedHashPlanes:
    """Partition keys by minimizer range and build one hash table per shard
    at a common width (JAX partition.py:100-186): `vals_dense` holds the
    table values (pool or dense ids), `vals` the raw values a `store_raw`
    (UID) table stores instead.

    Every shard is built at the common lb (the max of the per-shard
    minimums); a shard whose placement stalls there restarts every shard
    one bit wider, so the shards stay alike. `shards` lists the shards this
    process builds (default all; a mesh rank builds its own), and
    `any_failed(failed) -> bool` says whether a shard of the whole set
    stalled at this width (a collective over the mesh's db group; default:
    this process's own result). `check` is build_hash_table's self-check
    (the card's kernel on a card). `hash_sink` receives the stacked host
    planes when every shard was built here; `timings`, build_hash_table's
    step seconds summed over the shards built."""
    from ..db.hash_table import HashBuildError, build_hash_table

    bounds = partition_bins_equal_keys(offsets, n_shards)
    offsets = np.asarray(offsets, dtype=np.int64)
    key_slices = [(int(offsets[lo]), int(offsets[hi])) for lo, hi in bounds]
    shards = list(range(n_shards)) if shards is None else list(shards)
    values = vals if store_raw else vals_dense
    lb = _common_lb(key_slices, vals_dense, store_raw)
    while True:
        if lb > 30:
            raise HashBuildError(f"sharded hash tables do not fit 2^30 buckets a shard ({n_shards} shards)")
        planes: list = [None] * n_shards
        failed = False
        for i in shards:
            klo, khi = key_slices[i]
            steps: dict = {}
            try:
                planes[i], _ = build_hash_table(keys[klo:khi], values[klo:khi], force_lr=lb, layout="chd",
                                                store_raw=store_raw, check=check, timings=steps)
            except HashBuildError:
                failed = True
            if timings is not None:
                for step, s in steps.items():
                    timings[step] = timings.get(step, 0.0) + s
            if failed:
                break
        if any_failed is not None:
            failed = any_failed(failed)
        if not failed:
            break
        lb += 1
    sp = ShardedHashPlanes(planes=planes, lb=lb, bounds=bounds, store_raw=store_raw)
    if hash_sink is not None and len(shards) == n_shards:
        hash_sink.append((sp.stacked(), lb, bounds))
    return sp


def shard_cache_path(kdb_path: str, n_shards: int, pooled: bool) -> str:
    """The port's shard cache beside the kdb: one file per shard count, pool
    or dense ids apart (as db/device_db.CACHE_SUFFIX keeps them)."""
    return f"{kdb_path}.ht{n_shards}" + ("_torch" if pooled else "_dense_torch")


def _save_shard_cache(mesh, path, own, lb, bounds, kdb_path, taxdb_path, store_raw, pool) -> str:
    """Write the shard cache from the ranks of data row 0: each writes its
    shard's planes to a part file, the db group agrees that every part was
    written, and db rank 0 stacks the parts into the one cache file. Returns
    "miss" or "write_failed" (not fatal), as DeviceDB.timings says it."""
    from ..db.ht_cache import save_ht_cache

    if mesh.data_i != 0:
        return "miss"  # the other data rows built the same shards
    parts = [f"{path}.part{j}.npz" for j in range(mesh.n_db)]
    tmp = f"{parts[mesh.db_j]}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, *own)
        os.replace(tmp, parts[mesh.db_j])
        ok = True
    except OSError:
        ok = False
    ok = not mesh.any_db(not ok)
    if ok and mesh.db_j == 0:
        try:
            shards = []
            for p in parts:
                with np.load(p) as z:
                    shards.append(tuple(z[f"arr_{i}"] for i in range(len(own))))
            stacked = tuple(np.stack(ps) for ps in zip(*shards))
            extra = {"bounds": [list(b) for b in bounds]}
            if pool is not None:
                extra["pool_rows"] = pool.rows
            ok = save_ht_cache(path, stacked, lb, kdb_path, taxdb_path, extra=extra, store_raw=store_raw)
        except OSError:
            ok = False
    mesh.any_db(False)  # the parts stay until db rank 0 has read them
    for p in (parts[mesh.db_j], tmp):
        try:
            os.unlink(p)
        except OSError:
            pass
    return "miss" if ok else "write_failed"


def load_sharded_db(db_dir, mesh, taxonomy, pool="auto", vals_dense=None, uid_database: bool = False):
    """This rank's shard of a database's hash table on the rank's device
    (JAX pipeline.py:356-450): the keys of shard `mesh.db_j` of `mesh.n_db`
    equal-key minimizer ranges, in a table at the width every shard shares.
    `pool` and `vals_dense` as db/device_db.load_database_dir takes them.
    The stacked shards are cached beside the database (`shard_cache_path`,
    with the shard bounds and the pool's rows); a hit reads the stack and
    keeps its own shard. Returns a DeviceDB whose table is the shard's and
    whose vals_dense are the whole database's (the counts file, the
    counters' registers); timings split as load_database_dir's, with
    "shard_keys"."""
    from ..db.device_db import DeviceDB, _card_self_check, _sync, _to_device, compute_vals_dense
    from ..db.ht_cache import load_ht_cache
    from ..db.pool import build_value_pool
    from ..formats import read_index, read_kdb

    db_dir = os.fspath(db_dir)
    kdb_path = os.path.join(db_dir, "uid_database.kdb" if uid_database else "database.kdb")
    taxdb_path = os.path.join(db_dir, "taxDB")
    with trace.span("load.tables.read") as read:
        hdr, keys, vals = read_kdb(kdb_path)
        _idx_type, nt, offsets = read_index(os.path.join(db_dir, "database.idx"))
        if uid_database:
            vals_dense, pool = np.zeros(len(vals), np.int32), None
        elif vals_dense is None:
            vals_dense = compute_vals_dense(vals, taxonomy)
        vals_dense = np.ascontiguousarray(vals_dense, dtype=np.int32)
        if pool == "auto":
            pool = build_value_pool([vals_dense], taxonomy)  # None if > u16
    n, j = mesh.n_db, mesh.db_j
    path = shard_cache_path(kdb_path, n, pool is not None)
    timings: dict = {}
    own = None
    with trace.span("load.tables.cache_read") as cache_read:
        cached = load_ht_cache(path, kdb_path, taxdb_path, store_raw=uid_database)
        if cached is not None:
            stacks, lb, extra = cached
            extra = extra or {}
            c_rows = extra.get("pool_rows")
            space_ok = (c_rows is None) == (pool is None) and (
                pool is None or np.array_equal(np.asarray(c_rows), pool.rows))
            if space_ok and extra.get("bounds") is not None and all(s.shape[0] == n for s in stacks):
                own = tuple(np.ascontiguousarray(s[j]) for s in stacks)
                bounds = [tuple(b) for b in extra["bounds"]]
            del stacks
    # the db group builds together (its collectives): one rank's miss is
    # every rank's, as when another data row writes the cache in between
    if mesh.any_db(own is None):
        own = None
    if own is not None:
        timings.update(cache="hit", cache_read=cache_read.seconds)
    else:
        steps: dict = {}
        with trace.span("load.tables.build") as build:
            table_vals = vals if uid_database else pool.pool_index(vals_dense) if pool is not None else vals_dense
            check = _card_self_check(mesh.device) if mesh.device.type == "cuda" else None
            sp = shard_hash_tables(keys, vals, table_vals, offsets, n, store_raw=uid_database, shards=[j],
                                   any_failed=mesh.any_db, check=check, timings=steps)
            del table_vals
        own, lb, bounds = sp.planes[j], sp.lb, sp.bounds
        # the build's wall with the cache read it follows
        timings.update(build=cache_read.seconds + build.seconds, **{f"build_{s}": v for s, v in steps.items()})
        with trace.span("load.tables.cache_write") as cache_write:
            timings["cache"] = _save_shard_cache(mesh, path, own, lb, bounds, kdb_path, taxdb_path, uid_database,
                                                 pool)
        timings["cache_write"] = cache_write.seconds
    with trace.span("load.tables.upload") as upload:
        table = tuple(_to_device(p, mesh.device) for p in own)
        _sync(table[-1])
        offsets = np.asarray(offsets, dtype=np.int64)
        lo, hi = bounds[j]
        db = DeviceDB(
            vals_dense=vals_dense, k=hdr.k, nt=nt, key_ct=int(offsets[hi] - offsets[lo]), hash_table=table,
            hash_lb=lb, pool=pool, store_raw=uid_database, offsets=offsets,
        )
    db.timings = {"read": read.seconds, **timings, "upload": upload.seconds, "shard_keys": db.key_ct}
    print(f"mesh: {db_dir} shard {j} of {n}: {db.key_ct} keys at width 2^{lb} (cache {timings['cache']})",
          file=sys.stderr)
    return db
