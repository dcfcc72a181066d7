"""Device-resident k-mer database: the CHD hash table on a torch device.

Counterpart of krakenuniq_tpu/db/device_db.py for the resident hash/pool
case. The sorted (k-mer -> LCA taxid) pairs of `database.kdb` stay on the
host; only the CHD table (db/hash_table.py) goes to the device, as int32
planes holding its uint32 words. Table values are value-pool ids
(db/pool.py) when the database's LCA closure fits 16 bits, else dense
taxonomy ids.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..formats import read_index, read_kdb
from ..taxonomy import Taxonomy
from .hash_table import build_hash_table
from .pool import ValuePool, build_value_pool


@dataclasses.dataclass
class DeviceDB:
    vals_dense: np.ndarray  # int32 [N] host: DB values as dense taxonomy ids
    k: int
    nt: int
    key_ct: int
    hash_table: tuple  # (disp4 int32 [2^(lr-4), 4], rows int32 [2^lr, 4]) on device
    hash_lb: int  # row bits lr
    pool: ValuePool | None = None  # None: table values are dense ids
    # set-up wall seconds by step: "read" (kdb, dense values, pool),
    # "build" (host CHD placement and self-check), "upload" (to the device)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def table_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.hash_table)


def compute_vals_dense(vals: np.ndarray, taxonomy: Taxonomy) -> np.ndarray:
    """Dense-index the value column, warning on taxa the taxonomy lacks."""
    vals_dense = taxonomy.dense_index(vals)
    unknown = (vals_dense == 0) & (vals != 0)
    if unknown.any():
        import sys

        print(
            f"warning: {int(unknown.sum())} DB values reference taxa missing "
            f"from the taxonomy (treated as unclassified)",
            file=sys.stderr,
        )
    return vals_dense


def _to_device(plane: np.ndarray, device) -> torch.Tensor:
    """uint32 host plane -> int32 device tensor with the same bits."""
    a = np.ascontiguousarray(plane)
    if not a.flags.writeable:  # torch tensors may not alias read-only memory
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def device_db_from_host(host_planes, lr: int, pool, k: int, nt: int, device,
                        vals_dense: np.ndarray | None = None) -> DeviceDB:
    """A DeviceDB over already-built host CHD planes: `host_planes` =
    (disp4, rows) uint32 numpy arrays as the JAX package's
    `build_hash_table(..., to_device=False, keep_host=True)` returns them,
    `pool` the ValuePool whose ids the table stores (None = dense ids)."""
    disp4, rows = host_planes
    if disp4.ndim != 2 or disp4.shape[1] != 4 or rows.ndim != 2 or rows.shape[1] != 4:
        raise NotImplementedError(
            "only the CHD (disp4, rows) layout is ported; the fused and "
            "two-level layouts belong to a later slice of the port"
        )
    vd = np.zeros(0, np.int32) if vals_dense is None else vals_dense
    return DeviceDB(
        vals_dense=vd,
        k=k,
        nt=nt,
        key_ct=len(vd),
        hash_table=(_to_device(disp4, device), _to_device(rows, device)),
        hash_lb=lr,
        pool=pool,
    )


def load_database_dir(
    db_dir: str | os.PathLike,
    taxonomy: Taxonomy | None = None,
    device="cuda",
    pool: ValuePool | str | None = "auto",
    vals_dense: np.ndarray | None = None,
) -> tuple[DeviceDB, Taxonomy]:
    """Load a reference-layout database directory (`database.kdb`,
    `database.idx`, `taxDB`) and put its CHD table on `device`. `pool`:
    "auto" builds this database's own value pool; a ValuePool shares one id
    space across hierarchical databases; None stores dense ids.
    `vals_dense` skips recomputing the dense values when the caller has
    them (the joint-pool path)."""
    t0 = time.perf_counter()
    db_dir = os.fspath(db_dir)
    if taxonomy is None:
        taxonomy = Taxonomy.from_taxdb_file(os.path.join(db_dir, "taxDB"))
    hdr, keys, vals = read_kdb(os.path.join(db_dir, "database.kdb"))
    _idx_type, nt, _offsets = read_index(os.path.join(db_dir, "database.idx"))
    if vals_dense is None:
        vals_dense = compute_vals_dense(vals, taxonomy)
    vals_dense = np.ascontiguousarray(vals_dense, dtype=np.int32)
    if pool == "auto":
        pool = build_value_pool([vals_dense], taxonomy)  # None if > u16
    table_vals = pool.pool_index(vals_dense) if pool is not None else vals_dense
    t1 = time.perf_counter()
    build_steps: dict = {}
    host_planes, lr = build_hash_table(keys, table_vals, timings=build_steps)
    del keys, vals, table_vals
    t2 = time.perf_counter()
    db = device_db_from_host(
        host_planes, lr, pool, hdr.k, nt, device, vals_dense=vals_dense
    )
    if db.hash_table[1].is_cuda:
        torch.cuda.synchronize(db.hash_table[1].device)
    db.timings = {"read": t1 - t0, "build": t2 - t1, "upload": time.perf_counter() - t2,
                  **{f"build_{k}": v for k, v in build_steps.items()}}
    return db, taxonomy
