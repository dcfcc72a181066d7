"""On-disk cache of the port's built hash tables.

Counterpart of krakenuniq_tpu/db/ht_cache.py. Building the table of a
110M-key database costs about a hundred seconds of host work (murmur,
placement, plane construction, the self-check) per process; the reference
amortizes its own index construction by writing database.idx once at build
time (build_db.sh:194-209). The port writes the built planes next to the
database after the first successful build, and a later load is one bulk
file read and the upload.

The port's files are its own: `<kdb>.ht_torch` (value-pool ids),
`<kdb>.ht_dense_torch` (dense ids; raw values beside `uid_database.kdb`)
and `<kdb>.htc_torch` (out-of-core chunk tables; db/device_db.py and
db/chunked.py name them). It never reads,
writes or deletes the JAX package's `.ht`, `.ht_dense`, `.htc` or
`.ht1`-`.ht8` files.

Validity: the table stores pool or dense ids, so it depends on the kdb pair
file and on the taxonomy (taxDB) that defined the dense remap (a UID
database's `uid_database.kdb` tables store raw values: `store_raw`, as the
JAX package's `_meta` records it). The header
records (size, mtime_ns) of each, whether the values are raw, the port's
`_VERSION` and a digest of the
sources whose code decides the planes' bytes (`TABLE_SOURCES`, and
`CHUNK_SOURCES` for the chunk tables), so an edit to any of them rebuilds
the caches without a version bump; the callers also hold the value pool's
rows (and, for chunks, the budget and chunk_multiple) against what they
would build. Any mismatch, and any file that does not load, is a miss: the
caller rebuilds and writes anew.

Format: an uncompressed .npz holding `meta` (json), the plane arrays
`p0, p1, ...` ((disp4, rows) of a CHD table, (fused,) of a fused one,
(ptags, confirm) of a raw two-level one, the chunk tables' planes in order) and `x_<name>` for array-valued side data.
Each write goes to a temporary name unique to the process and is then
renamed over the cache (os.replace), so concurrent writers never
interleave and a reader sees a whole file or none.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import secrets

import numpy as np

_VERSION = 1  # the port's own; bump when a plane layout or value space changes

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the sources, relative to the package, whose code decides a table's bytes:
# the plane builds, the placement (the native module's chd_place), the
# murmur hash and the value pool; the chunk tables add the planner
TABLE_SOURCES = ("db/hash_table.py", "db/pool.py", "utils/bits.py", "native/kuniq_native.cpp")
CHUNK_SOURCES = TABLE_SOURCES + ("db/chunked.py", "parallel/partition.py")


@functools.lru_cache(maxsize=None)
def _digest(root: str, sources: tuple) -> str:
    h = hashlib.sha256()
    for rel in sources:
        with open(os.path.join(root, rel), "rb") as fh:
            h.update(rel.encode() + b"\0" + fh.read() + b"\0")
    return h.hexdigest()[:16]


def code_digest(sources=TABLE_SOURCES) -> str:
    """A digest of the package's `sources` as they stand on disk."""
    return _digest(_PKG, tuple(sources))


def _dep_stat(path: str):
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def _meta(kdb_path: str, taxdb_path: str | None, lb: int, sources, store_raw: bool, extra=None):
    deps = {os.path.basename(kdb_path): _dep_stat(kdb_path)}
    if taxdb_path is not None and os.path.exists(taxdb_path):
        deps[os.path.basename(taxdb_path)] = _dep_stat(taxdb_path)
    meta = {"version": _VERSION, "code": code_digest(sources), "lb": int(lb), "store_raw": bool(store_raw),
            "deps": deps}
    if extra:
        meta["extra"] = extra
    return meta


def save_ht_cache(ht_path: str, host_planes, lb: int, kdb_path: str, taxdb_path: str | None,
                  extra=None, sources=TABLE_SOURCES, store_raw: bool = False) -> bool:
    """Write the planes to `ht_path`; returns False when the write failed (a
    read-only database directory, a full disk), which is not fatal. `extra`
    is side metadata returned verbatim on load: numpy arrays are stored as
    npz arrays, the rest as json. `sources` names the code the planes
    depend on; `store_raw` says that they hold raw values (a UID
    database's two-level planes)."""
    extra_arrays = {}
    if extra:
        extra = dict(extra)
        for k in list(extra):
            if isinstance(extra[k], np.ndarray):
                extra_arrays[f"x_{k}"] = extra.pop(k)
        extra = extra or None
    meta = _meta(kdb_path, taxdb_path, lb, sources, store_raw, extra)
    arrays = {f"p{i}": np.asarray(p) for i, p in enumerate(host_planes)}
    arrays.update(extra_arrays)
    tmp = f"{ht_path}.{os.getpid()}.{secrets.token_hex(4)}.tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, ht_path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_ht_cache(ht_path: str, kdb_path: str, taxdb_path: str | None, sources=TABLE_SOURCES,
                  store_raw: bool = False):
    """Returns (host_planes, lb, extra) or None on a miss, a stale file, a
    file of the other value kind (raw or not) or a file that does not
    load."""
    if not os.path.exists(ht_path):
        return None
    try:
        with np.load(ht_path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            extra = meta.get("extra")
            if meta != _meta(kdb_path, taxdb_path, meta.get("lb", 0), sources, store_raw, extra):
                return None
            planes = []
            while f"p{len(planes)}" in z.files:
                planes.append(z[f"p{len(planes)}"])
            if not planes:
                return None
            x_keys = [k for k in z.files if k.startswith("x_")]
            if x_keys:
                extra = dict(extra or {})
                for k in x_keys:
                    extra[k[2:]] = z[k]
        return tuple(planes), int(meta["lb"]), extra
    except Exception:  # a truncated or foreign file is a miss: the caller rebuilds
        return None
