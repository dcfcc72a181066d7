"""Device-resident k-mer database on a torch device.

Counterpart of krakenuniq_tpu/db/device_db.py. The database is the sorted
(canonical k-mer -> LCA taxid) pairs of `database.kdb` with the minimizer
offset table of `database.idx` (reference krakendb.cpp:60-78/528-593):
  keys    uint64 [N]   sorted within each minimizer bin
  vals    uint32 [N]   LCA taxid (original id space)
  vals_dense int32 [N] taxid as a dense taxonomy index
  offsets int64 [4^nt + 1]
The default lookup is the hash table (db/hash_table.py): only its planes go
to the device, as int32 planes holding its uint32 words, and the sorted
pairs stay on the host. Table values are value-pool ids (db/pool.py) when
the database's LCA closure fits 16 bits, else dense taxonomy ids; a UID
database (`uid_database.kdb`, whose values are taxon-set ids) stores its
raw values in the two-level layout (`store_raw`), with no pool and zero
dense values. When
the table build fails (CHD, then the fused layout) the database falls
back to the binary search over the sorted planes, which go to the device
instead (`sorted_planes`: keys int64, vals int32, vals_dense int32,
offsets int64, each the bits of its host array) and answer in dense ids.

`load_database_dir` keeps the built table in the port's cache next to the
database (`<kdb>.ht_torch`, `<kdb>.ht_dense_torch`, the latter also for
`uid_database.kdb`; db/ht_cache.py).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..formats import read_index, read_kdb
from ..taxonomy import Taxonomy
from .hash_table import HashBuildError, build_hash_table
from .ht_cache import load_ht_cache, save_ht_cache
from .pool import ValuePool, build_value_pool

# the port's cache files beside `database.kdb`: table values are pool ids,
# or dense ids (cached apart, so alternating modes keep both)
CACHE_SUFFIX = {True: ".ht_torch", False: ".ht_dense_torch"}


@dataclasses.dataclass
class DeviceDB:
    vals_dense: np.ndarray  # int32 [N] host: DB values as dense taxonomy ids
    k: int
    nt: int
    key_ct: int
    # the table on the device: CHD (disp4 int32 [2^(lr-2), 4], rows int32
    # [2^lr, 4]), fused (int32 [2^lb, 4],) or raw two-level (ptags int32
    # [2^lb, 2], confirm int32 [2^(lb+1), 2]); None: the table build failed
    # and lookups search sorted_planes
    hash_table: tuple | None
    hash_lb: int  # row bits lr (CHD) or bucket bits lb (fused, raw)
    pool: ValuePool | None = None  # None: table values are dense ids (or raw)
    store_raw: bool = False  # table values are the raw 32-bit DB values (UID)
    # the sorted pairs on the host (uint64, uint32) and the bin offsets
    # (int64); None for a table given as planes alone (device_db_from_host)
    keys: np.ndarray | None = None
    vals: np.ndarray | None = None
    offsets: np.ndarray | None = None
    max_bin: int = 0  # largest bin (bounds the binary search's trip count)
    bin_start: int = 0  # first minimizer bin the offsets cover
    # the binary-search planes on the device: (keys int64, vals int32,
    # vals_dense int32, offsets int64); set on a failed table build, or by
    # upload_sorted_planes when the run searches every database
    sorted_planes: tuple | None = None
    # set-up wall seconds by step: "read" (kdb, dense values, pool),
    # "cache_read" (a hit) or "build" (host placement and self-check) and
    # "cache_write", "upload" (to the device); "cache" is "hit", "miss"
    # (built, and written) or "write_failed" (built, not written)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def search_iters(self) -> int:
        """Binary-search steps that settle any lane: ceil(log2(max_bin + 1)) + 1."""
        return max(1, int(np.ceil(np.log2(self.max_bin + 1))) + 1)

    @property
    def table_bytes(self) -> int:
        """Device bytes of the lookup's planes (the table, or sorted_planes)."""
        planes = self.hash_table if self.hash_table is not None else self.sorted_planes or ()
        return sum(p.numel() * p.element_size() for p in planes)

    def upload_sorted_planes(self, device) -> tuple:
        """The binary-search planes on `device`, uploaded once."""
        if self.sorted_planes is None:
            self.sorted_planes = _sorted_planes(self.keys, self.vals, self.vals_dense, self.offsets, device)
        return self.sorted_planes


def compute_vals_dense(vals: np.ndarray, taxonomy: Taxonomy) -> np.ndarray:
    """Dense-index the value column, warning on taxa the taxonomy lacks."""
    vals_dense = taxonomy.dense_index(vals)
    unknown = (vals_dense == 0) & (vals != 0)
    if unknown.any():
        print(
            f"warning: {int(unknown.sum())} DB values reference taxa missing "
            f"from the taxonomy (treated as unclassified)",
            file=sys.stderr,
        )
    return vals_dense


def _to_device(plane: np.ndarray, device, dtype=np.int32) -> torch.Tensor:
    """A host plane -> a device tensor of `dtype` with the same bits."""
    a = np.ascontiguousarray(plane)
    if not a.flags.writeable:  # torch tensors may not alias read-only memory
        a = a.copy()
    return torch.from_numpy(a.view(dtype)).to(device)


def _sorted_planes(keys, vals, vals_dense, offsets, device) -> tuple:
    return (
        _to_device(np.ascontiguousarray(keys, np.uint64), device, np.int64),
        _to_device(np.ascontiguousarray(vals, np.uint32), device),
        _to_device(np.ascontiguousarray(vals_dense, np.int32), device),
        _to_device(np.ascontiguousarray(offsets, np.int64), device, np.int64),
    )


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


_CHECK_KEYS = 1 << 24  # keys a pass of the card's self-check


def _card_self_check(device):
    """The build's self-check on a card: the planes uploaded and every key
    probed through the table's own kernel (hash_lookup.probe_values), 2^24
    keys a pass, against its value word; returns the check function for
    build_hash_table (the keys that do not probe back). The host's numpy
    mirror of the probe takes 20-55 s at 10^8 keys, the card a few seconds,
    most of them the copies."""
    from ..lookup.hash_lookup import probe_values

    def check(host_planes, hashes, values, width) -> int:
        planes = tuple(_to_device(p, device) for p in host_planes)
        n_bad = 0
        for s in range(0, len(hashes), _CHECK_KEYS):
            h = _to_device(hashes[s : s + _CHECK_KEYS], device, np.int64)
            want = _to_device(values[s : s + _CHECK_KEYS], device)
            n_bad += int((probe_values(planes, h) != want).sum())
        return n_bad

    return check


def device_db_from_host(host_planes, lr: int, pool, k: int, nt: int, device,
                        vals_dense: np.ndarray | None = None) -> DeviceDB:
    """A DeviceDB over already-built host table planes: `host_planes` =
    (disp4, rows) of the CHD layout, (fused,) of the fused one or (ptags,
    confirm) of the raw two-level one (a UID database: raw values, pool
    None), uint32 numpy arrays as the JAX package's `build_hash_table(...,
    to_device=False, keep_host=True)` returns them; `lr` their width and
    `pool` the ValuePool whose ids the table stores (None = dense ids)."""
    shapes = [tuple(p.shape) for p in host_planes]
    raw = len(shapes) == 2 and shapes[0][1:] == (2,)
    if not (len(shapes) in (1, 2) and all(len(s) == 2 and s[1] == (2 if raw else 4) for s in shapes)):
        raise ValueError(f"no table layout has planes of shapes {shapes}")
    vd = np.zeros(0, np.int32) if vals_dense is None else vals_dense
    return DeviceDB(
        vals_dense=vd,
        k=k,
        nt=nt,
        key_ct=len(vd),
        hash_table=tuple(_to_device(p, device) for p in host_planes),
        hash_lb=lr,
        pool=pool,
        store_raw=raw,
    )


def build_device_db(
    keys: np.ndarray,
    vals: np.ndarray,
    offsets: np.ndarray,
    k: int,
    nt: int,
    taxonomy: Taxonomy | None,
    device="cuda",
    cached_hash: tuple | None = None,  # (host_planes, lb) from the cache
    pool: ValuePool | str | None = "auto",  # "auto" = build own; None = dense ids
    vals_dense: np.ndarray | None = None,  # precomputed dense values
    store_raw: bool = False,  # a UID database: the table stores the raw values
) -> DeviceDB:
    """The JAX package's build_device_db: the table (from `cached_hash`, or
    built: CHD, else the fused layout; the two-level layout of raw values
    with `store_raw`, which has no pool and zero dense values) on `device`,
    or with a failed build (or no taxonomy) the sorted planes. A failed
    build never fails the load: it warns and falls back to the binary
    search, which answers every query the table would (krakendb.cpp:
    250-321), in dense ids. `timings` of the result hold "build" and
    "upload" (the caller adds the rest)."""
    return _build_device_db(keys, vals, offsets, k, nt, taxonomy, device, cached_hash, pool, vals_dense,
                            store_raw)[0]


def _build_device_db(keys, vals, offsets, k, nt, taxonomy, device, cached_hash, pool, vals_dense,
                     store_raw=False):
    """build_device_db, and the (host_planes, lb) it built (None when they
    came from `cached_hash` or the build failed) for the cache."""
    offsets = np.asarray(offsets, dtype=np.int64)
    bin_sizes = np.diff(offsets)
    max_bin = int(bin_sizes.max()) if len(bin_sizes) else 0
    if vals_dense is None:
        vals_dense = (compute_vals_dense(vals, taxonomy) if taxonomy is not None and not store_raw
                      else np.zeros(len(vals), dtype=np.int32))
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    vals_dense = np.ascontiguousarray(vals_dense, dtype=np.int32)
    use_hash = taxonomy is not None
    if not use_hash or store_raw:
        pool = None
    elif pool == "auto":
        pool = build_value_pool([vals_dense], taxonomy)  # None if > u16
    timings: dict = {}
    built = None
    t0 = time.perf_counter()
    host_planes, hlb = cached_hash if cached_hash is not None else (None, 0)
    if use_hash and host_planes is None:
        table_vals = vals if store_raw else pool.pool_index(vals_dense) if pool is not None else vals_dense
        steps: dict = {}
        try:
            host_planes, hlb = built = build_hash_table(
                keys, table_vals, timings=steps, store_raw=store_raw,
                check=_card_self_check(device) if torch.device(device).type == "cuda" else None,
            )
        except HashBuildError as e:
            # never hard-fail on valid input: the bsearch planes answer
            # every query the hash table would; slower but correct
            print(
                f"warning: hash-table build failed ({e}); falling back to binary-search lookup",
                file=sys.stderr,
            )
            use_hash = False
            pool = None  # the bsearch planes answer in dense-id space
        timings.update(build=time.perf_counter() - t0, **{f"build_{s}": v for s, v in steps.items()})
    t1 = time.perf_counter()
    db = DeviceDB(
        vals_dense=vals_dense, k=k, nt=nt, key_ct=len(keys), hash_table=None, hash_lb=0,
        keys=keys, vals=vals, offsets=offsets, max_bin=max_bin,
    )
    if use_hash:
        db.hash_table = tuple(_to_device(p, device) for p in host_planes)
        db.hash_lb, db.pool, db.store_raw = hlb, pool, store_raw
        _sync(db.hash_table[-1])
    else:
        _sync(db.upload_sorted_planes(device)[0])
    db.timings = {**timings, "upload": time.perf_counter() - t1}
    return db, built


def load_database_dir(
    db_dir: str | os.PathLike,
    taxonomy: Taxonomy | None = None,
    device="cuda",
    pool: ValuePool | str | None = "auto",
    vals_dense: np.ndarray | None = None,
    uid_database: bool = False,
) -> tuple[DeviceDB, Taxonomy]:
    """Load a reference-layout database directory (`database.kdb`,
    `database.idx`, `taxDB`) onto `device`. `pool`: "auto" builds this
    database's own value pool; a ValuePool shares one id space across
    hierarchical databases; None stores dense ids. `vals_dense` skips
    recomputing the dense values when the caller has them (the joint-pool
    path). `uid_database` loads `uid_database.kdb` instead (JAX
    device_db.py:180-250): raw values in the two-level table, no value pool,
    zero dense values, the cache at `uid_database.kdb.ht_dense_torch`.

    The built table is cached beside the database (`<kdb>.ht_torch` for pool
    ids, `<kdb>.ht_dense_torch` for dense ids) and a later load reads it in
    place of the build, when the kdb, the taxDB, the port's cache version and
    the pool's rows all match; anything else rebuilds and rewrites it. A
    failed write (a read-only directory) is not fatal. DeviceDB.timings
    says which ("cache": "hit", "miss" or "write_failed")."""
    t0 = time.perf_counter()
    db_dir = os.fspath(db_dir)
    taxdb_path = os.path.join(db_dir, "taxDB")
    kdb_path = os.path.join(db_dir, "uid_database.kdb" if uid_database else "database.kdb")
    if taxonomy is None:
        taxonomy = Taxonomy.from_taxdb_file(taxdb_path)
    hdr, keys, vals = read_kdb(kdb_path)
    _idx_type, nt, offsets = read_index(os.path.join(db_dir, "database.idx"))
    if uid_database:
        # set ids, not taxids: no dense mapping and no pool
        vals_dense, pool = np.zeros(len(vals), np.int32), None
    elif vals_dense is None:
        vals_dense = compute_vals_dense(vals, taxonomy)
    vals_dense = np.ascontiguousarray(vals_dense, dtype=np.int32)
    if pool == "auto":
        pool = build_value_pool([vals_dense], taxonomy)  # None if > u16
    t1 = time.perf_counter()
    # the cached table's value space must be the pool in use: a joint pool
    # of hierarchical databases differs from the database's own
    ht_path = kdb_path + CACHE_SUFFIX[pool is not None]
    cached = load_ht_cache(ht_path, kdb_path, taxdb_path, store_raw=uid_database)
    if cached is not None:
        c_rows = (cached[2] or {}).get("pool_rows")
        if (c_rows is None) != (pool is None) or (
            pool is not None and not np.array_equal(np.asarray(c_rows), pool.rows)
        ):
            cached = None
        else:
            cached = cached[:2]
    t2 = time.perf_counter()
    db, built = _build_device_db(keys, vals, offsets, hdr.k, nt, taxonomy, device, cached, pool, vals_dense,
                                 uid_database)
    timings = {"read": t1 - t0, **db.timings}
    if cached is not None:
        timings.update(cache="hit", cache_read=t2 - t1)
    else:
        timings["cache"] = "miss"
        if built is not None:
            t3 = time.perf_counter()
            host_planes, lb = built
            extra = {"pool_rows": pool.rows} if db.pool is not None else None
            if not save_ht_cache(ht_path, host_planes, lb, kdb_path, taxdb_path, extra=extra,
                                 store_raw=uid_database):
                timings["cache"] = "write_failed"
            timings["cache_write"] = time.perf_counter() - t3
    db.timings = timings
    return db, taxonomy
