"""Random row-fetch rate against the number of copies in flight.

Counterpart of tools/probe_dma_exp.py. The question it answers on the card:
how many random rows per second can device memory serve, and how does the
rate grow with the copies each thread keeps in flight? The `row_gather`
kernel (csrc/row_gather.cu) fetches rows of a [R, row_words] uint32 table at
random indices with S 16-byte cp.async copies in flight per lane (a ring
of S slots, waiting on copy i-S before issuing copy i, as the TPU kernel's
semaphore ring did), in one-warp blocks of max(16, S) copies per lane by
default; each output is checked against `index_select`, which is also
timed as the library control.

It sweeps S at the TPU tool's defaults: a 2^26 x 16-byte-row table (1 GiB)
viewed as 2^21 rows of 512 bytes, 8,519,680 queries. It also runs 16-byte
rows, the CHD table's row size (db/hash_table.py), which the TPU backend
could not compile. One JSON line per (row size, S) goes to stdout.

    python -m krakenuniq_tpu_torch.tools.probe_gather [--rows 26]
        [--queries 8519680] [--depths 1,4,16,64,256] [--row-bytes 16,512]
        [--loads K] [--reps 5]

It needs a card and exits with 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

import torch

from .. import _kernels

DEPTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256)  # S values the kernel is built for
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def row_gather_plain(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of `row_gather`."""
    return table.index_select(0, q)


def copies_per_lane(depth: int, loads_per_lane: int | None = None) -> int:
    """The copies each lane of a `row_gather` block makes in all: the
    caller's loads_per_lane, by default max(16, depth), so that a lane's
    ring of depth copies fills before it drains."""
    return max(16, depth) if loads_per_lane is None else loads_per_lane


def gather_geometry(n: int, row_words: int, depth: int, loads_per_lane: int | None = None) -> dict:
    """The launch `row_gather` makes for n rows of row_words words on the
    current CUDA device, as the kernel's C entry reports it (it launches
    nothing): threads per block, blocks, shared memory per block, and the
    blocks one SM holds by the occupancy calculator."""
    copies = copies_per_lane(depth, loads_per_lane)
    out = (ctypes.c_longlong * 4)()
    fn = _kernels.entry("row_gather", "kuniq_row_gather_geometry",
                        (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    rc = fn(n, row_words, depth, copies, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"row_gather geometry failed with CUDA error {rc}")
    return {"threads": out[0], "blocks": out[1], "copies_per_lane": copies, "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def row_gather(table: torch.Tensor, q: torch.Tensor, depth: int = 16,
               loads_per_lane: int | None = None) -> torch.Tensor:
    """table[q] for an int32 [R, row_words] table (row_words a multiple of 4
    dividing 128) and int32 indices q [n] in [0, R), with `depth` 16-byte
    copies in flight per lane and `loads_per_lane` copies per lane in all
    (default max(16, depth): `copies_per_lane`), so a one-warp block fetches
    loads_per_lane * 32 * 4 / row_words rows. CUDA tensors launch the
    `row_gather` kernel."""
    if table.device.type == "cpu":
        return row_gather_plain(table, q)
    dev = _kernels.check_cuda("row_gather", table=table, q=q)
    if table.dtype != torch.int32 or table.dim() != 2 or q.dtype != torch.int32 or q.dim() != 1:
        raise TypeError("row_gather: table must be int32 [R, row_words] and q int32 [n]")
    row_words = table.shape[1]
    if row_words % 4 or 128 % row_words or table.data_ptr() % 16:
        raise ValueError("row_gather: row_words must be a multiple of 4 dividing 128, table 16-byte aligned")
    copies = copies_per_lane(depth, loads_per_lane)
    if depth not in DEPTHS or not 1 <= copies < (1 << 31):
        raise ValueError(f"row_gather: depth must be one of {DEPTHS}, loads_per_lane >= 1")
    out = torch.empty((q.shape[0], row_words), dtype=torch.int32, device=dev)
    _kernels.launch(
        "row_gather", dev, table, q, out, q.shape[0], table.shape[0], row_words, depth, copies,
    )
    return out


def time_ms(fn, reps: int) -> float:
    """Median device milliseconds of fn() over `reps` CUDA-event pairs,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def gather_bound_ms(n: int, row_bytes: int) -> float:
    """Bytes the fetch must move: a 4-byte index, one row read and one row
    written per query, over the memory rate."""
    return n * (4 + 2 * row_bytes) / HBM_BYTES_PER_S * 1e3


def sweep(rows_log2: int = 26, n_queries: int = 8_519_680, depths=(1, 4, 16, 64, 256),
          row_bytes=(16, 512), loads_per_lane: int | None = None, reps: int = 5, seed: int = 7,
          emit=print):
    """Run the sweep on the current CUDA device; one record per (row size,
    S), each checked against index_select, plus one library record per row
    size. Returns the records."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = (1 << rows_log2) * 4  # the 16-byte-row table's uint32 words
    flat = torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32, device=dev, generator=gen)
    recs = []
    for rb in row_bytes:
        table = flat.view(-1, rb // 4)
        q = torch.randint(0, table.shape[0], (n_queries,), dtype=torch.int32, device=dev, generator=gen)
        want = row_gather_plain(table, q)
        lib_ms = time_ms(lambda: row_gather_plain(table, q), reps)
        rec = {"probe": "index_select", "row_bytes": rb, "rows": table.shape[0],
               "queries": n_queries, "ms": lib_ms, "m_rows_per_s": n_queries / lib_ms / 1e3,
               "bound_ms": gather_bound_ms(n_queries, rb)}
        emit(json.dumps(rec))
        recs.append(rec)
        for s in depths:
            got = row_gather(table, q, s, loads_per_lane)
            if not torch.equal(got, want):
                raise AssertionError(f"row_gather S={s} row_bytes={rb}: differs from index_select")
            del got
            ms = time_ms(lambda: row_gather(table, q, s, loads_per_lane), reps)
            rec = {"probe": "row_gather", "row_bytes": rb, "depth": s,
                   **gather_geometry(n_queries, rb // 4, s, loads_per_lane), "rows": table.shape[0],
                   "queries": n_queries, "ms": ms, "ns_per_row": ms * 1e6 / n_queries,
                   "m_rows_per_s": n_queries / ms / 1e3,
                   "bound_ms": gather_bound_ms(n_queries, rb), "equal": True}
            emit(json.dumps(rec))
            recs.append(rec)
        del want, q, table
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=26, help="log2 of the 16-byte table rows")
    ap.add_argument("--queries", type=int, default=8_519_680)
    ap.add_argument("--depths", default="1,4,16,64,256", help="copies in flight per thread")
    ap.add_argument("--row-bytes", default="16,512")
    ap.add_argument("--loads", type=int, default=None,
                    help="copies per lane in all (default: max(16, S))")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather: no CUDA device available", file=sys.stderr)
        return 2
    sweep(
        args.rows, args.queries, [int(s) for s in args.depths.split(",")],
        [int(b) for b in args.row_bytes.split(",")], args.loads, args.reps,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
