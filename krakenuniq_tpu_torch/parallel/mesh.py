"""The data x db mesh over torch.distributed, and its spawner.

Counterpart of krakenuniq_tpu/parallel/mesh.py. A mesh of n_data * n_db
ranks, one process each, rank = data_i * n_db + db_j:
  * the database tables are minimizer-range sharded along "db" (shard db_j
    on every rank of column j; parallel/partition.load_sharded_db) and the
    rows of each batch along "data" (rows [data_i * B / n_data, ...));
  * after each database's probe the ranks of a data row (the `db_group`)
    sum their words (each k-mer's bin lives on exactly one shard,
    classify.cpp:447), before the first-database-wins update
    (classify.cpp:927-936), so every rank of the row then holds the merged
    words and resolves its rows with them;
  * a span dictionary (local_dict) merges over the ranks of a column (the
    `data_group`), so every data slice's rows speak one dictionary;
  * the step's outputs come to global rank 0 over the data group of column
    0, and rank 0 alone formats, counts and writes (classify/pipeline.py).
    This keeps the single-controller meaning of the JAX package's shard_map
    program.

Only two collectives are used, `all_reduce` and `broadcast`: gloo takes CUDA
tensors for those two only, and ranks that share one card can only run over
gloo (NCCL refuses two ranks on one GPU). The JAX package's all_gather and
pmax become an all_reduce of a zero-filled plane in which each rank writes
its own slot (`gather_rows`, `merge_dict`) and an all_reduce(MAX). The
backend is NCCL when every rank has a card of its own and gloo when ranks
share a card or run on the CPU (`choose_backend`), chosen once and printed
on stderr; it never changes after a failure.

`spawn_mesh` starts the ranks (torch.multiprocessing, a file rendezvous in a
temporary directory) and returns rank 0's result; the CLI's --mesh, the
tests and chip_smoke.py all start meshes through it, so a spawned rank
imports only this package.

The JAX module's programs map so: make_sharded_classify_fn keeps its name
(the step on a rank's rows and shards, gathered to rank 0);
make_sharded_probe_fn is classify/device_step.probe_chunk_core(..., mesh=)
and make_sharded_acc_classify_fn classify_step_core(acc, ..., mesh=) with
lookup_mode "acc", which the pipeline calls directly.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os
import pickle
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from ..utils import trace

# a rank that never reaches a collective fails its peers' calls after this
COLLECTIVE_TIMEOUT_S = 1800.0
_LUT_PAD = 1 << 30  # above any dense id: keeps a span dictionary sorted (classify/device_step.py)


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: cuda:{rank % cards} (ranks share cards round-robin),
    or the CPU when asked for. "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world: int, device, backend: str | None = None) -> str:
    """NCCL when every one of `world` ranks has a card of its own, gloo when
    ranks share a card or run on the CPU. An explicit `backend` is checked,
    never replaced: NCCL on the CPU, or with more ranks than cards, raises."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if backend is None:
        return "nccl" if dev.type == "cuda" and world <= cards else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and (dev.type != "cuda" or world > cards):
        raise ValueError(f"the nccl backend needs a card a rank: {world} ranks on {dev.type} with {cards} cards "
                         "(use gloo)")
    return backend


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in an n_data x n_db mesh and its process groups."""

    n_data: int
    n_db: int
    rank: int
    device: torch.device
    backend: str
    db_group: object = None  # the ranks of this data row (None: a row of one rank)
    data_group: object = None  # the ranks of this db column (None: a column of one rank)
    # host seconds ("mesh.merge" spans) and calls of the db merges (the
    # collective alone: the card's queue is drained before the span opens)
    merge_seconds: float = 0.0
    merge_calls: int = 0

    @property
    def data_i(self) -> int:
        return self.rank // self.n_db

    @property
    def db_j(self) -> int:
        return self.rank % self.n_db

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def rows(self, b: int) -> slice:
        """This rank's rows of a batch of b rows (b a multiple of n_data)."""
        if b % self.n_data:
            raise ValueError(f"a batch of {b} rows does not split over {self.n_data} data ranks")
        s = b // self.n_data
        return slice(self.data_i * s, (self.data_i + 1) * s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def merge_db(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a word plane over the db group, in place (the JAX psum over
        "db"): bool planes go as uint8."""
        if self.n_db == 1:
            return t
        self._sync()
        with trace.span("mesh.merge") as sp:
            if t.dtype == torch.bool:
                u = t.to(torch.uint8)
                dist.all_reduce(u, group=self.db_group)
                t.copy_(u != 0)
            else:
                dist.all_reduce(t, group=self.db_group)
            self._sync()
        self.merge_seconds += sp.seconds
        self.merge_calls += 1
        return t

    def any_db(self, flag: bool) -> bool:
        """Whether any rank of the db group says `flag`."""
        if self.n_db == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.db_group)
        return bool(t.item())

    def broadcast_flag(self, flag: bool | None) -> bool:
        """Rank 0's `flag` on every rank (the others pass None)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def gather_rows(self, out: dict, b: int, to_all: bool = False):
        """The step's row planes at full height b (every [rows, ...] plane
        of `out`; "lut", the same on every rank, passes as it is). The
        ranks of db column 0 (all ranks with `to_all`) write their rows into
        one zero-filled byte plane and sum it over their data group, so
        every byte has one writer and the sum is exact in every dtype.
        Returns the full planes on global rank 0 (on every rank with
        `to_all`), None on the others."""
        if self.n_data == 1:
            return out if to_all or self.is_root else None
        if self.db_j != 0 and not to_all:
            return None
        rows = self.rows(b)
        keys = [k for k, t in out.items() if k != "lut"]
        parts = [out[k].contiguous().view(torch.uint8).reshape(out[k].shape[0], -1) for k in keys]
        buf = torch.zeros((b, sum(p.shape[1] for p in parts)), dtype=torch.uint8, device=self.device)
        col = 0
        for p in parts:
            buf[rows, col : col + p.shape[1]] = p
            col += p.shape[1]
        dist.all_reduce(buf, group=self.data_group)
        if not (to_all or self.is_root):
            return None
        full, col = {}, 0
        for k, p in zip(keys, parts):
            t = out[k]
            full[k] = buf[:, col : col + p.shape[1]].contiguous().view(t.dtype).reshape((b, *t.shape[1:]))
            col += p.shape[1]
        if "lut" in out:
            full["lut"] = out["lut"]
        return full

    def merge_dict(self, lut: torch.Tensor, cap: int):
        """One span dictionary from every data slice's (JAX device_step.py:
        316-335): lut int32 [cap + 1] (sorted ids, 2^30 padding, the count
        last) written into this rank's slot of a zero-filled [n_data, cap + 1]
        plane summed over the data group; the union's first `cap` ids sorted,
        and the count the larger of the union's and the largest local count
        (all_reduce MAX: a slice past the cap dropped ids before the merge).
        Returns (merged lut int32 [cap], count int32 [])."""
        slots = torch.zeros((self.n_data, cap + 1), dtype=torch.int32, device=self.device)
        slots[self.data_i] = lut
        dist.all_reduce(slots, group=self.data_group)
        n_u_local = lut[cap : cap + 1].clone()
        dist.all_reduce(n_u_local, op=dist.ReduceOp.MAX, group=self.data_group)
        s = torch.sort(slots[:, :cap].reshape(-1)).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        first &= s != _LUT_PAD
        ranks = torch.cumsum(first, 0, dtype=torch.int32)
        merged = torch.full((cap,), _LUT_PAD, dtype=torch.int32, device=self.device)
        keep = first & (ranks <= cap)
        merged[(ranks[keep] - 1).long()] = s[keep]
        return merged, torch.maximum(ranks[-1], n_u_local[0])


_MESHES: dict = {}


def make_mesh(n_data: int, n_db: int, device="cuda") -> Mesh:
    """This rank's Mesh over the initialized torch.distributed world, which
    must hold exactly n_data * n_db ranks. Every rank creates every row's
    and every column's group in one order (dist.new_group is collective);
    the mesh of a shape is made once a process."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a {n_data}x{n_db} mesh needs torch.distributed initialized "
                           "(start the ranks with parallel.mesh.spawn_mesh)")
    world = dist.get_world_size()
    if n_data < 1 or n_db < 1 or world != n_data * n_db:
        raise ValueError(f"a {n_data}x{n_db} mesh needs a world of {n_data * n_db} ranks, have {world}")
    key = (n_data, n_db, id(dist.group.WORLD))
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    backend = dist.get_backend()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks")
    mesh = Mesh(n_data=n_data, n_db=n_db, rank=rank, device=dev, backend=backend)
    for i in range(n_data):
        ranks = [i * n_db + j for j in range(n_db)]
        g = dist.new_group(ranks) if n_db > 1 else None
        if i == mesh.data_i:
            mesh.db_group = g
    for j in range(n_db):
        ranks = [i * n_db + j for i in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if j == mesh.db_j:
            mesh.data_group = g
    _MESHES[key] = mesh
    return mesh


def _rank_main(rank, n_data, n_db, device, backend, tmp, threads):
    """A spawned rank: its device, the process group (file rendezvous in
    `tmp`), its Mesh, fn(mesh, *args) of tmp/job; rank 0's result goes to
    tmp/result. `threads`: the rank's torch threads on the CPU."""
    with open(os.path.join(tmp, "job"), "rb") as fh:
        fn, args = pickle.load(fh)
    world = n_data * n_db
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = fn(make_mesh(n_data, n_db, device), *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.tmp"), "wb") as fh:
                pickle.dump(result, fh)
            os.replace(os.path.join(tmp, "result.tmp"), os.path.join(tmp, "result"))
    finally:
        _MESHES.clear()
        dist.destroy_process_group()


def spawn_mesh(fn, n_data: int, n_db: int, device="cuda", args=(), backend: str | None = None,
               timeout: float | None = None):
    """Run fn(mesh, *args) on n_data * n_db spawned ranks and return rank 0's
    result. `fn` must be importable by the children (a module-level function
    of this package). Ranks go on cuda:{rank % cards} (gloo when they share
    a card, NCCL when each has its own) or, with device="cpu", on the CPU
    (gloo); the backend is printed on stderr. A rank that raises, or a run
    past `timeout` seconds, terminates every rank and raises here."""
    world = n_data * n_db
    if n_data < 1 or n_db < 1:
        raise ValueError(f"bad mesh {n_data}x{n_db}")
    rank_device(device, 0)  # "cuda" without a card raises here, not in the ranks
    backend = choose_backend(world, device, backend)
    where = torch.device(device).type
    if where == "cuda":
        where = f"{min(world, torch.cuda.device_count())} card(s)"
    print(f"mesh {n_data}x{n_db}: {world} ranks on {where}, backend {backend}", file=sys.stderr)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="kuniq_mesh_") as tmp:
        # the job goes by file: arguments past a pipe's buffer would hold
        # each start until the rank before had imported torch
        with open(os.path.join(tmp, "job"), "wb") as fh:
            pickle.dump((fn, args), fh)
        # the ranks share the caller's torch threads
        threads = max(1, torch.get_num_threads() // world)
        ctx = mp.start_processes(_rank_main, args=(n_data, n_db, str(device), backend, tmp, threads),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):  # raises when a rank failed
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"mesh {n_data}x{n_db}: ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(os.path.join(tmp, "result"), "rb") as fh:
            return pickle.load(fh)


# ------------------------------------------------ the JAX module's programs


_SIGNED = {"uint64": "int64", "uint32": "int32", "uint16": "int16"}


def _on_device(x, device):
    """A host array (unsigned ones as the signed type's bits) or tensor on
    `device`; scalars pass as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if not hasattr(x, "ndim") or x.ndim == 0:
        return x
    a = x.view(_SIGNED[x.dtype.name]) if x.dtype.name in _SIGNED else x
    return torch.from_numpy(a.copy()).to(device)


def _slice_feed(mesh: Mesh, codes, ambig, lengths):
    """This rank's rows of a batch, on its device."""
    rows = mesh.rows(codes.shape[0])
    return tuple(_on_device(a[rows], mesh.device) for a in (codes, ambig, lengths))


def make_sharded_classify_fn(mesh: Mesh, planes, taxid_table, io_table, parent, root_dense: int, cfg):
    """fn(codes, ambig, lengths) -> the step's outputs at full height on
    rank 0 (None on the others): the classify step on this rank's rows and
    its db shard of each database (`planes`: a ShardedHashPlanes or
    ShardedDBPlanes, or a list of them in hierarchy order, the shards'
    planes on the rank's device or host), the words merged over the db
    group (JAX mesh.py:43-174). cfg.lookup_mode must match the planes."""
    from ..classify.device_step import classify_step_core

    planes_list = list(planes) if isinstance(planes, (list, tuple)) else [planes]
    for p in planes_list:
        if p.n_shards != mesh.n_db:
            raise ValueError(f"{p.n_shards} shards on a mesh of {mesh.n_db} db ranks")

    db_planes = tuple(tuple(_on_device(x, mesh.device) for x in p.shard_planes(mesh.db_j)) for p in planes_list)
    taxid_table, io_table, parent = (_on_device(x, mesh.device) for x in (taxid_table, io_table, parent))

    def fn(codes, ambig, lengths):
        out = classify_step_core(db_planes, taxid_table, io_table, parent, root_dense,
                                 *_slice_feed(mesh, codes, ambig, lengths), cfg, mesh=mesh)
        return mesh.gather_rows(out, codes.shape[0])

    return fn


# ------------------------------------------------------ the ranks' workers


def sharded_step_rank(mesh: Mesh, planes, tables, feed, cfg):
    """One rank of a check of the sharded step: make_sharded_classify_fn
    over `planes` (host shards), `tables` = (taxid_table, io, parent,
    root_dense) host arrays and the host batch `feed` = (codes, ambig,
    lengths); rank 0 returns the outputs as numpy arrays."""
    out = make_sharded_classify_fn(mesh, planes, *tables, cfg)(*feed)
    return None if out is None else {k: v.cpu().numpy() for k, v in out.items()}


def classify_rank(mesh: Mesh, db_dirs, options, inputs, uid_database: bool = False):
    """One rank of a mesh classification: every rank runs the Classifier
    over the same inputs; rank 0 returns its kraken output and report text,
    its finalized counts, span manifest and the run's counts of spans, work
    units, chunk groups and db merges, the others None."""
    from ..classify import Classifier

    c = Classifier(db_dirs, options, uid_database=uid_database)
    kraken = io.StringIO() if mesh.is_root else None
    c.run(inputs, kraken_fh=kraken)
    if not mesh.is_root:
        return None
    report = io.StringIO()
    c.write_report(report)
    return {"kraken": kraken.getvalue(), "report": report.getvalue(), "counts": c.finalized_counts(),
            "span_manifest": c.span_manifest, "n_spans": c.n_spans, "n_units": c.n_units,
            "ooc_groups": c.ooc_groups, "n_chunks": [cdb.n_chunks for cdb in c._ooc or ()],
            "merge_calls": mesh.merge_calls}


def run_mesh(db_dirs, options, inputs, uid_database: bool = False, timeout: float | None = None):
    """Classify `inputs` on a mesh of options.mesh_data x options.mesh_db
    spawned ranks on options.device; returns rank 0's classify_rank result."""
    return spawn_mesh(classify_rank, options.mesh_data, options.mesh_db, options.device,
                      args=(db_dirs, options, inputs, uid_database), timeout=timeout)
