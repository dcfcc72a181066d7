"""Out-of-core database chunking: the `--preload-size` engine.

Counterpart of krakenuniq_tpu/db/chunked.py. The reference classifies
databases larger than its memory by splitting the sorted pair array into
minimizer-range chunks that fit a byte budget and streaming them through
memory one at a time (krakendb.cpp:407-526, classify.cpp:566-791). Here the
CHD table (db/hash_table.py; a UID database's raw two-level table) is built
per minimizer-range chunk on the host,
each chunk sized so that its table fits the `--preload-size` device budget;
the classify pipeline streams the chunk tables through the card and folds
each k-mer's hit into a per-span accumulator (classify/device_step.
probe_chunk_core, the `chd_probe_acc` kernel, `rows_probe_acc` on raw
chunk tables), probing in each chunk only
the lanes whose minimizer bin lies in the chunk's range (`bounds`).

Correctness rests on the invariant the reference's chunk merge asserts
(classify.cpp:447): each k-mer lives in exactly one chunk, and the probe is
exact, so probing a chunk that does not own a k-mer's minimizer range
misses, and skipping that probe changes nothing. The cross-chunk merge is
a precedence select (keep the first nonzero word), which is also the
hierarchical first-database-wins rule (classify.cpp:927-936) when the
chunks of later databases are probed after the earlier ones'.

Chunks are cut along minimizer-bin boundaries (krakendb.cpp:430-461), and
all chunk tables of a database share one width, so one pair of device slots
of that shape holds any of them. The host planes are int32 tensors, pinned
chunk by chunk as each is built when they are bound for a card (so the
process never holds two copies of the set).

`load_chunked_db` keeps the built chunk tables in the port's cache beside
the database, `<kdb>.htc_torch` (db/ht_cache.py), valid while the kdb, the
taxDB, the port's cache version, the code of the build and the planner
(ht_cache.CHUNK_SOURCES), the value pool's rows, the budget and
chunk_multiple (a mesh's n_db, else 1) all match. It never reads, writes or deletes the JAX
package's `<kdb>.htc` files.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from .hash_table import (
    BUCKET_SLOTS,
    CHD_MAX_LOAD,
    HashBuildError,
    build_hash_table,
    chd_min_lr,
    chd_table_bytes,
)
from ..utils import trace
from .ht_cache import CHUNK_SOURCES, load_ht_cache, save_ht_cache

CACHE_SUFFIX = ".htc_torch"  # the port's chunk cache beside `database.kdb`
# raw (UID) two-level tables are 24 B a bucket (two tags, two confirm
# slots), loaded to 0.6, as the JAX package prices them
_RAW_BYTES_PER_BUCKET = 4 * 2 + 8 * 2
_CHUNK_LOAD_FACTOR = 0.6


def table_bytes(n_keys: int, max_value: int, store_raw: bool) -> int:
    """Device bytes of a single (unchunked) table over n_keys."""
    if store_raw:
        lb = max(
            4,
            int(np.ceil(np.log2(max(n_keys, 2) / (BUCKET_SLOTS * _CHUNK_LOAD_FACTOR)))),
        )
        return (1 << lb) * _RAW_BYTES_PER_BUCKET
    return chd_table_bytes(chd_min_lr(n_keys, max_value))


def plan_chunks(
    offsets: np.ndarray,
    budget_bytes: int,
    max_value: int,
    store_raw: bool,
    min_chunks: int = 1,
    chunk_multiple: int = 1,
) -> tuple[list[tuple[int, int]], int]:
    """Cut minimizer bins into chunks whose hash tables fit budget_bytes.

    Returns ([(bin_lo, bin_hi)), ...], common_lb). Mirrors the reference's
    largest-range-that-fits binary search (krakendb.cpp:430-461), realized as
    the smallest equal-key chunk count whose largest chunk fits the budget.
    `min_chunks` forces a finer cut (the retry after a placement stall);
    `chunk_multiple` rounds the count up to a multiple (a mesh's n_db: the
    chunks stream through the mesh in groups of one chunk a db rank).
    """
    from ..parallel.partition import partition_bins_equal_keys

    offsets = np.asarray(offsets, dtype=np.int64)
    total = int(offsets[-1])
    if store_raw:
        per_bucket = _RAW_BYTES_PER_BUCKET
        lb_budget = max(4, int(np.floor(np.log2(max(budget_bytes, 1) / per_bucket))))
        lb_floor = 4
        min_table = (1 << lb_floor) * per_bucket
        cap = int((1 << lb_budget) * BUCKET_SLOTS * _CHUNK_LOAD_FACTOR)
    else:
        # CHD layout (db/hash_table.py): 2^lr 16 B rows + 2^(lr-2) disp words
        lb_budget = max(4, int(np.floor(np.log2(max(budget_bytes, 1) / 17))))
        lb_floor = max(4, int(max_value).bit_length())
        min_table = chd_table_bytes(lb_floor)
        cap = int((1 << lb_budget) * 2 * CHD_MAX_LOAD)
    if lb_budget < lb_floor:
        raise ValueError(
            f"--preload-size {budget_bytes} is below the minimum chunk table "
            f"(width 2^{lb_floor} = {min_table} bytes)"
        )
    max_bin = int(np.diff(offsets).max()) if len(offsets) > 1 else total
    if max_bin > cap:
        raise ValueError(
            f"--preload-size {budget_bytes} cannot hold the largest minimizer "
            f"bin ({max_bin} keys); chunks cut along bin boundaries "
            "(krakendb.cpp:430-461) need a larger budget"
        )
    n_chunks = max(min_chunks, -(-total // cap)) if total else max(1, min_chunks)
    n_chunks = -(-n_chunks // chunk_multiple) * chunk_multiple
    while True:
        bounds = partition_bins_equal_keys(offsets, n_chunks)
        sizes = [int(offsets[hi] - offsets[lo]) for lo, hi in bounds]
        if max(sizes) <= cap:
            break
        n_chunks += chunk_multiple  # bin granularity overflowed a chunk; cut finer
    if store_raw:
        lb = max(
            max(4, int(np.ceil(np.log2(max(s, 2) / (BUCKET_SLOTS * _CHUNK_LOAD_FACTOR)))))
            for s in sizes
        )
    else:
        lb = max(chd_min_lr(s, max_value) for s in sizes)
    return bounds, min(lb, lb_budget)


@dataclasses.dataclass
class ChunkedHashDB:
    """One database's chunk tables on the host, streamed through the card.

    chunk_planes[i] is chunk i's (disp4 int32 [2^(lb-4), 4], rows int32
    [2^lb, 4]) CHD planes, or with `store_raw` its (ptags int32 [2^lb, 2],
    confirm int32 [2^(lb+1), 2]) raw two-level planes (uint32 bit
    patterns), all at the common width `lb`: pinned host tensors when bound
    for a card, plain ones for the CPU."""

    chunk_planes: list[tuple[torch.Tensor, torch.Tensor]]
    lb: int
    bounds: list  # minimizer-bin range per chunk
    k: int
    nt: int
    key_ct: int
    vals_dense: np.ndarray | None  # host dense values (counts-file generation)
    pool: object | None = None  # ValuePool when the table values are pool ids
    store_raw: bool = False  # raw (UID) values in two-level tables
    # set-up wall seconds of the "load.tables.<step>" spans: "read" (kdb,
    # dense values, pool), "cache_read" (a hit) or "build" (plan,
    # placement, planes, self-check) and "cache_write", "pin" (copies into
    # pinned memory); "cache" is "hit", "miss" (built, and written) or
    # "write_failed" (built, not written)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_planes)

    def chunk_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.chunk_planes[0])


def _host_tensor(plane: np.ndarray, pin: bool) -> torch.Tensor:
    """uint32 numpy plane -> int32 host tensor with the same bits (a pinned
    copy with `pin`, after which the numpy plane can go)."""
    t = torch.from_numpy(np.ascontiguousarray(plane).view(np.int32))
    return t.pin_memory() if pin else t


def chunked_db_from_planes(planes, lb: int, k: int, nt: int, bounds=None, key_ct: int = 0,
                           vals_dense: np.ndarray | None = None, pool=None,
                           pin: bool = False) -> ChunkedHashDB:
    """A ChunkedHashDB over already-built chunk tables: `planes` a list of
    (disp4, rows) or (ptags, confirm) uint32 numpy planes at width `lb`,
    such as the JAX package's build_chunked_db returns in its chunk_planes,
    and `bounds` each chunk's minimizer-bin range [lo, hi), which the chunk
    passes route lanes by (required)."""
    raw = bool(planes) and planes[0][0].shape[1:] == (2,)
    for p0, p1 in planes:
        s0, s1 = tuple(p0.shape), tuple(p1.shape)
        chd = len(s0) == 2 and s0[1] == 4 and s1 == (1 << lb, 4)
        if not ((s0, s1) == ((1 << lb, 2), (2 << lb, 2)) if raw else chd):
            raise ValueError(f"chunk planes {s0}, {s1} are neither CHD nor raw two-level tables of width "
                             f"2^{lb} (all alike)")
    if bounds is None or len(bounds) != len(planes):
        raise ValueError(
            f"chunk tables need one minimizer-bin range each: {len(planes)} tables, bounds {bounds!r}"
        )
    chunk_planes = [(_host_tensor(disp4, pin), _host_tensor(rows, pin)) for disp4, rows in planes]
    return ChunkedHashDB(
        chunk_planes=chunk_planes,
        lb=lb,
        bounds=[tuple(b) for b in bounds],
        k=k,
        nt=nt,
        key_ct=key_ct,
        vals_dense=vals_dense,
        pool=pool,
        store_raw=raw,
    )


def build_chunked_db(
    keys: np.ndarray,
    values: np.ndarray,
    offsets: np.ndarray,
    budget_bytes: int,
    k: int,
    nt: int,
    pin: bool = False,
    store_raw: bool = False,
    chunk_multiple: int = 1,
) -> ChunkedHashDB:
    """Build per-chunk CHD tables on the host over `keys` (the bin-sorted
    pair array, so each chunk's keys are a contiguous slice) -> `values`
    (pool or dense ids), or with `store_raw` raw two-level tables of the
    raw values (a UID database; JAX chunked.py:162-222), planned and
    widened by their 24 B a bucket.

    A chunk whose placement stalls at the planned width restarts the whole
    set: one bit wider if the budget allows (halves the load), else cut
    finer at the same width (fewer keys per chunk), as the JAX package's
    build_chunked_db does, so both plan alike. Each chunk's planes become
    host tensors (pinned with `pin`) as soon as they are built. The chunk
    count is a multiple of `chunk_multiple`."""
    values = np.asarray(values)
    vmax = int(values.max()) if len(keys) else 0
    offsets = np.asarray(offsets, dtype=np.int64)
    pin_s = 0.0
    min_chunks = 1
    lb_bump = 0

    def width_bytes(w: int) -> int:
        return (1 << w) * _RAW_BYTES_PER_BUCKET if store_raw else chd_table_bytes(w)

    while True:
        bounds, lb = plan_chunks(offsets, budget_bytes, vmax, store_raw, min_chunks, chunk_multiple)
        if width_bytes(lb + lb_bump) <= budget_bytes:
            lb = min(lb + lb_bump, 30)
        else:
            lb_bump = 0  # the replanned cut changed the base width; restart bumps
        chunk_planes = []
        ok = True
        for lo, hi in bounds:
            klo, khi = int(offsets[lo]), int(offsets[hi])
            try:
                host, _ = build_hash_table(keys[klo:khi], values[klo:khi], force_lr=lb, layout="chd",
                                           store_raw=store_raw)
            except HashBuildError:
                ok = False
                if width_bytes(lb + 1) <= budget_bytes:
                    lb_bump += 1
                else:
                    min_chunks = len(bounds) + 1
                break
            with trace.span("load.tables.pin") as pinned:
                chunk_planes.append(tuple(_host_tensor(p, pin) for p in host))
                del host
            pin_s += pinned.seconds
        if ok:
            break
    cdb = ChunkedHashDB(
        chunk_planes=chunk_planes,
        lb=lb,
        bounds=[tuple(b) for b in bounds],
        k=k,
        nt=nt,
        key_ct=len(keys),
        vals_dense=None,
        store_raw=store_raw,
    )
    cdb.timings["pin"] = pin_s
    return cdb


def load_chunked_db(
    db_dir: str | os.PathLike,
    budget_bytes: int,
    taxonomy,
    pool="auto",
    vals_dense: np.ndarray | None = None,
    pin: bool = False,
    uid_database: bool = False,
    chunk_multiple: int = 1,
) -> ChunkedHashDB:
    """Load a reference-layout database directory as a chunked (out-of-core)
    table set. `pool`: "auto" builds the database's own value pool
    (db/pool.py), a ValuePool shares a joint id space (hierarchical
    databases), None stores dense ids. `vals_dense` skips recomputing the
    dense values when the caller has them. `pin` pins each chunk's planes
    for the card's copy engines. `uid_database` loads `uid_database.kdb`
    as raw two-level chunk tables (JAX chunked.py:230-316): no pool, no
    dense values. `chunk_multiple`: the chunk count is a multiple of it (a
    mesh's n_db). The chunk tables come from the port's cache
    `<kdb>.htc_torch` when it holds them for this kdb, taxDB, value kind,
    pool, budget, chunk_multiple and code; else they are built and the cache written
    (a failed write is not fatal). ChunkedHashDB.timings["cache"] says
    which."""
    from ..formats import read_index, read_kdb
    from .device_db import compute_vals_dense
    from .pool import build_value_pool

    db_dir = os.fspath(db_dir)
    kdb_path = os.path.join(db_dir, "uid_database.kdb" if uid_database else "database.kdb")
    taxdb_path = os.path.join(db_dir, "taxDB")
    with trace.span("load.tables.read") as read:
        hdr, keys, vals = read_kdb(kdb_path)
        _idx_type, nt, offsets = read_index(os.path.join(db_dir, "database.idx"))
        if uid_database:  # set ids, not taxids: no dense values and no pool
            vals_dense, pool = None, None
        else:
            if vals_dense is None:
                vals_dense = compute_vals_dense(vals, taxonomy)
            vals_dense = np.ascontiguousarray(vals_dense, dtype=np.int32)
        if pool == "auto":
            pool = build_value_pool([vals_dense], taxonomy)  # None if > u16
    htc_path = kdb_path + CACHE_SUFFIX
    cdb = None
    with trace.span("load.tables.cache_read") as cache_read:
        cached = load_ht_cache(htc_path, kdb_path, taxdb_path, CHUNK_SOURCES, store_raw=uid_database)
        hit = False
        if cached is not None:
            planes, lb, extra = cached
            extra = extra or {}
            c_rows = extra.get("pool_rows")
            space_ok = (c_rows is None) == (pool is None) and (
                pool is None or np.array_equal(np.asarray(c_rows), pool.rows))
            # a cache without one bin range a chunk is a miss: the passes route by them
            bounds = extra.get("bounds")
            hit = (space_ok and extra.get("budget") == budget_bytes and extra.get("chunk_multiple") == chunk_multiple
                   and len(planes) % 2 == 0 and bounds is not None and len(bounds) == len(planes) // 2)
    if hit:
        with trace.span("load.tables.pin") as pinned:
            cdb = chunked_db_from_planes(
                [planes[i : i + 2] for i in range(0, len(planes), 2)], lb, hdr.k, nt,
                bounds=bounds, key_ct=len(keys), pin=pin,
            )
        cdb.timings.update(cache="hit", cache_read=cache_read.seconds, pin=pinned.seconds)
    if cdb is None:
        with trace.span("load.tables.build") as build:
            table_vals = vals if uid_database else pool.pool_index(vals_dense) if pool is not None else vals_dense
            cdb = build_chunked_db(keys, table_vals, offsets, budget_bytes, hdr.k, nt, pin=pin,
                                   store_raw=uid_database, chunk_multiple=chunk_multiple)
            del table_vals
        # the build's wall beside its pinning, with the cache read it follows
        cdb.timings["build"] = cache_read.seconds + build.seconds - cdb.timings["pin"]
        with trace.span("load.tables.cache_write") as cache_write:
            extra = {"budget": budget_bytes, "bounds": [list(b) for b in cdb.bounds],
                     "chunk_multiple": chunk_multiple}
            if pool is not None:
                extra["pool_rows"] = pool.rows
            flat = [p.numpy().view(np.uint32) for planes in cdb.chunk_planes for p in planes]
            ok = save_ht_cache(htc_path, flat, cdb.lb, kdb_path, taxdb_path, extra=extra, sources=CHUNK_SOURCES,
                               store_raw=uid_database)
        cdb.timings.update(cache="miss" if ok else "write_failed", cache_write=cache_write.seconds)
    del keys, vals
    cdb.vals_dense = vals_dense
    cdb.pool = pool
    cdb.timings["read"] = read.seconds
    print(
        f"out-of-core: {db_dir} split into {cdb.n_chunks} chunk tables of {cdb.chunk_bytes()} "
        f"bytes at width 2^{cdb.lb} (budget {budget_bytes} bytes)",
        file=sys.stderr,
    )
    return cdb


class ChunkSlots:
    """The device slots that chunk tables stream through: each slot holds
    one chunk table of the largest chunk shape of `dbs` (a database's
    chunks all share one width; a narrower database uses a prefix), and is
    allocated once, at its first use, so the caching allocator never hands
    its memory to another stream's tensor. Copies run on their own stream.

    Two events per slot order the reuse: a copy into a slot waits for the
    last probe that read the slot (`release`), and a probe waits for the
    copy (`planes`). With two slots the next chunk's copy runs while the
    current chunk's probes do; a slot that already holds the wanted chunk
    is not copied again. On the CPU the host planes are used as they are."""

    def __init__(self, dbs: list[ChunkedHashDB], device: torch.device):
        self.device = device
        self._sizes = (max(c.chunk_planes[0][0].numel() for c in dbs),
                       max(c.chunk_planes[0][1].numel() for c in dbs))
        self._planes: list = []
        self._holds: list = []  # per slot: (id of its database, chunk index)
        self._copied: list = []  # per slot: event after its last copy
        self._released: list = []  # per slot: event after the last probe that read it
        self.stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None

    def _slot(self, s: int):
        while len(self._planes) <= s:
            self._planes.append(tuple(torch.empty(n, dtype=torch.int32, device=self.device)
                                      for n in self._sizes))
            self._holds.append(None)
            self._copied.append(torch.cuda.Event())
            self._released.append(torch.cuda.Event())
        return self._planes[s]

    def load(self, s: int, cdb: ChunkedHashDB, ci: int, timing: list | None = None) -> None:
        """Start the copy of cdb's chunk ci into slot s, after the last probe
        that read the slot, unless the slot holds it already; `timing` gets
        the copy's (start, end) CUDA events."""
        if self.stream is None:
            return
        slot = self._slot(s)
        if self._holds[s] == (id(cdb), ci):
            return
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self._released[s])
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if timing is not None else None
            if evs:
                evs[0].record(self.stream)
            for dst, src in zip(slot, cdb.chunk_planes[ci]):
                dst[: src.numel()].copy_(src.view(-1), non_blocking=True)
            if evs:
                evs[1].record(self.stream)
                timing.append(evs)
            self._copied[s].record(self.stream)
        self._holds[s] = (id(cdb), ci)

    def planes(self, s: int, cdb: ChunkedHashDB, ci: int):
        """Chunk ci's (disp4, rows) planes for the current stream, which is
        made to wait for the slot's copy."""
        if self.stream is None:
            return cdb.chunk_planes[ci]
        if self._holds[s] != (id(cdb), ci):
            raise RuntimeError(f"chunk slot {s} does not hold chunk {ci}")
        torch.cuda.current_stream(self.device).wait_event(self._copied[s])
        return tuple(dst[: src.numel()].view(src.shape)
                     for dst, src in zip(self._planes[s], cdb.chunk_planes[ci]))

    def release(self, s: int) -> None:
        """Mark the end of the probes that read slot s (on the current stream)."""
        if self.stream is not None:
            self._released[s].record(torch.cuda.current_stream(self.device))
