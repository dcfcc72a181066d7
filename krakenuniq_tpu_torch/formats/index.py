"""Kraken minimizer index (.idx) format.

Layout (reference src/krakendb.cpp:534-544, 118-148):
  bytes 0..6   magic: "KRAKIDX" (v1, plain minimizer order) or
                      "KRAKIX2" (v2, XOR-scrambled minimizer order)
  u8 @ 7       nt  (minimizer length in bases)
  then (4^nt + 1) uint64 bin start offsets into the pair array
  (offsets[b] .. offsets[b+1]-1 are the pairs whose bin key == b).
"""

from __future__ import annotations

import os

import numpy as np

KRAKEN_IDX_MAGIC_V1 = b"KRAKIDX"
KRAKEN_IDX_MAGIC_V2 = b"KRAKIX2"


def read_index(path: str | os.PathLike, mmap: bool = True):
    """Read a .idx file -> (idx_type, nt, offsets u64[4^nt + 1])."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:7] == KRAKEN_IDX_MAGIC_V1:
        idx_type = 1
    elif head[:7] == KRAKEN_IDX_MAGIC_V2:
        idx_type = 2
    else:
        raise ValueError(f"{path}: illegal Kraken DB index format ({head[:7]!r})")
    nt = head[7]
    n_entries = (1 << (2 * nt)) + 1
    if mmap:
        raw = np.memmap(path, dtype=np.uint8, mode="r", offset=8)
        offsets = raw[: n_entries * 8].view("<u8")
    else:
        offsets = np.fromfile(path, dtype="<u8", count=n_entries, offset=8)
    if len(offsets) != n_entries:
        raise ValueError(f"{path}: truncated index (want {n_entries} offsets)")
    return idx_type, int(nt), offsets


def write_index(
    path: str | os.PathLike,
    nt: int,
    offsets: np.ndarray,
    idx_type: int = 2,
) -> None:
    n_entries = (1 << (2 * nt)) + 1
    offsets = np.ascontiguousarray(offsets, dtype="<u8")
    if len(offsets) != n_entries:
        raise ValueError(f"need {n_entries} offsets for nt={nt}, got {len(offsets)}")
    magic = KRAKEN_IDX_MAGIC_V2 if idx_type == 2 else KRAKEN_IDX_MAGIC_V1
    with open(path, "wb") as f:
        f.write(magic)
        f.write(bytes([nt]))
        f.write(offsets.tobytes())
