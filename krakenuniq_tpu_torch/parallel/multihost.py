"""Multi-host classification: hosts x cards.

Counterpart of krakenuniq_tpu/parallel/multihost.py. Each host drives its
own cards (one device, or a data x db mesh of parallel/mesh.py over the
host's cards), while the read stream is sharded ACROSS hosts by
deterministic span interleaving: global span s belongs to host s % n_hosts.
Spans are groups of whole work units (classify.cpp:511-521's deterministic
>= 500 kbp units), so every unit-local HLL fold -- and therefore the
sparse/dense regime and every report column -- is bit-identical to the
single-host run.

Host-side result merging follows the reference's own out-of-core pattern
(classify.cpp:390-485 merges per-worker temp files by read index): each
host writes its kraken output plus a span manifest, and serializes its
per-taxon counter state; host 0 concatenates the output segments in global
span order and folds the counter states with the order-independent
ReadCounts merge. No cross-host device collective is required for
classification itself; `initialize` still brings up torch.distributed so
deployments can barrier and share one coordinator-provided process id.
Everything but `initialize` is numpy, pickle and file I/O, as in the JAX
package.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    platform: str | None = None,
    backend: str | None = None,
) -> tuple[int, int]:
    """Bring up torch.distributed from the arguments or KUNIQ_COORDINATOR (a
    tcp://host:port address) / KUNIQ_NUM_PROCS / KUNIQ_PROC_ID; returns
    (rank, world). Without an address, (0, 1) and nothing starts.

    The backend: gloo on the CPU (`platform="cpu"`, or no card), NCCL where
    every process of this host has a card of its own
    (parallel/mesh.choose_backend over KUNIQ_LOCAL_PROCS processes a host,
    default 1); an explicit `backend` is checked, never replaced."""
    import torch
    import torch.distributed as dist

    from .mesh import choose_backend, rank_device

    coordinator_address = coordinator_address or os.environ.get("KUNIQ_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("KUNIQ_NUM_PROCS", 0)) or None
    if process_id is None:
        pid_env = os.environ.get("KUNIQ_PROC_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if coordinator_address is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs the process count and this process's id "
                         "(arguments, or KUNIQ_NUM_PROCS / KUNIQ_PROC_ID)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    device = "cpu" if platform == "cpu" or not torch.cuda.is_available() else "cuda"
    local = int(os.environ.get("KUNIQ_LOCAL_PROCS", 1))
    backend = choose_backend(local, device, backend)
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda", process_id % local))
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=1800))
    return dist.get_rank(), dist.get_world_size()


def owns_span(span_idx: int, host_id: int, n_hosts: int) -> bool:
    """Deterministic cross-host input sharding: global span s is
    processed by host s % n_hosts (spans = whole work-unit groups, keeping
    the HLL fold bit-reproducible)."""
    return span_idx % n_hosts == host_id


class MultihostTimeout(RuntimeError):
    """Raised by rendezvous_and_merge when peers never arrive.

    Carries the lost host ids so callers can recover: every artifact in the
    flow is idempotent (the reference's restartable-build pattern,
    build_db.sh:116), so the lost work is exactly the missing hosts' span
    shares -- re-run the SAME command with --multihost LOST/N on any
    surviving machine (or let the CLI's --multihost-recover auto mode do it
    in-process), then host 0's rendezvous completes."""

    def __init__(self, missing_hosts: list, n_hosts: int, output: str, timeout: float):
        self.missing_hosts = list(missing_hosts)
        self.n_hosts = n_hosts
        self.output = output
        shares = ", ".join(
            f"host {i} (global spans s with s % {n_hosts} == {i})"
            for i in self.missing_hosts
        )
        super().__init__(
            f"multi-host rendezvous timed out after {timeout}s; lost {shares}. "
            f"Markers checked: {output}.done<ID>. Recover by re-running the "
            f"same command with --multihost ID/{n_hosts} for each lost host "
            f"on any machine (artifacts are idempotent), then re-run host 0."
        )


def write_done_marker(output: str, host_id: int) -> None:
    """Drop the completion marker a rendezvous polls for -- used by the
    normal flow and by recovery code that re-ran a lost host's share."""
    with open(f"{output}.done{host_id}", "w") as fh:
        fh.write(str(os.getpid()))


# ---------------------------------------------------------------- state files


def save_counter_state(path: str, counts: dict) -> None:
    """Serialize a finalized {taxid: ReadCounts} map (HLL sparse/dense
    state, exact sets, and counters) for the cross-host fold."""
    recs = []
    for taxid, rc in counts.items():
        k = rc.kmers
        if k is None:
            cont = ("none",)
        elif hasattr(k, "sparse"):  # HLL
            cont = (
                "hll",
                k.p,
                bool(k.sparse),
                np.asarray(k.sparse_set),
                None if k.M is None else np.asarray(k.M),
                int(k.n_observed),
            )
        else:  # ExactCounter
            cont = ("exact", np.asarray(k.kmers))
        recs.append((int(taxid), int(rc.n_reads), int(rc.n_kmers), cont))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(recs, fh)
    os.replace(tmp, path)


def load_counter_state(path: str) -> dict:
    from ..hll import HLL, ExactCounter, ReadCounts

    with open(path, "rb") as fh:
        recs = pickle.load(fh)
    out = {}
    for taxid, n_reads, n_kmers, cont in recs:
        if cont[0] == "none":
            k = None
        elif cont[0] == "hll":
            _, p, sparse, sparse_set, m_arr, n_obs = cont
            k = HLL(p, sparse=sparse)
            k.sparse_set = np.asarray(sparse_set, np.uint32)
            k.M = None if m_arr is None else np.asarray(m_arr, np.uint8)
            k.n_observed = n_obs
        else:
            k = ExactCounter()
            k.kmers = np.asarray(cont[1], np.uint64)
        rc = ReadCounts(k)
        rc.n_reads = n_reads
        rc.n_kmers = n_kmers
        out[taxid] = rc
    return out


def merge_counts(into: dict, other: dict) -> dict:
    """Fold another host's finalized counts in (order-independent: the
    ReadCounts merge implements the reference's HLL/exact merge rules)."""
    for taxid, rc in other.items():
        if taxid in into:
            into[taxid].iadd(rc)
        else:
            # copy on first insert: later folds iadd into the merged entry,
            # which must not mutate the caller-owned `other` dict's objects
            # (e.g. a live finalized_counts result)
            into[taxid] = rc.copy()
    return into


def merge_kraken_outputs(out_path: str, parts: list) -> None:
    """Concatenate per-host kraken output segments in global span order.

    `parts` is one (path, manifest) per host, where manifest is the host's
    [(global_span_idx, byte_start, byte_end), ...] -- the cross-host
    analogue of the reference's merge of per-worker temp files by read
    index (classify.cpp:390-485)."""
    segs = []
    for path, manifest in parts:
        for span_idx, b0, b1 in manifest:
            segs.append((span_idx, path, b0, b1))
    segs.sort()
    with open(out_path, "wb") as out:
        handles = {}
        for _idx, path, b0, b1 in segs:
            fh = handles.get(path)
            if fh is None:
                fh = handles[path] = open(path, "rb")
            fh.seek(b0)
            out.write(fh.read(b1 - b0))
        for fh in handles.values():
            fh.close()


def rendezvous_and_merge(
    host_id: int,
    n_hosts: int,
    output: str,
    report_file: str | None,
    timeout: float = 3600.0,
    poll_s: float = 0.2,
) -> list | None:
    """Single-command multi-host finish over a shared filesystem.

    Every host calls this after its artifacts (<output>.part<ID> segment,
    its .manifest, and -- when reporting -- <report>.state.<ID>) are fully
    written:

    * each host drops a completion marker <output>.done<ID>;
    * hosts != 0 return None immediately -- their work is done;
    * host 0 polls for every peer marker (up to `timeout` seconds), merges
      the kraken segments in global span order into <output> (the
      cross-host analogue of classify.cpp:390-485's by-read-index merge),
      consumes the markers, and returns the list of peer counter-state
      paths for the caller to fold into the final report.

    Stale markers: callers should remove their own marker before starting a
    run (the CLI does) so a rerun cannot rendezvous against a previous
    run's leftovers.
    """
    import json
    import time

    write_done_marker(output, host_id)
    if host_id != 0:
        return None

    peers = [i for i in range(n_hosts) if i != 0]
    deadline = time.monotonic() + timeout
    missing = list(peers)
    while missing:
        missing = [i for i in missing if not os.path.exists(f"{output}.done{i}")]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise MultihostTimeout(missing, n_hosts, output, timeout)
        time.sleep(poll_s)

    parts = []
    for i in range(n_hosts):
        part = f"{output}.part{i}"
        with open(part + ".manifest") as mf:
            parts.append((part, json.load(mf)))
    merge_kraken_outputs(output, parts)
    for i in range(n_hosts):
        try:
            os.unlink(f"{output}.done{i}")
        except OSError:
            pass
    if report_file is None:
        return []
    return [f"{report_file}.state.{i}" for i in peers]
