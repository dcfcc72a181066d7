"""Reading a Kraken database's pairs (`database.kdb`), frozen for the
benchmark: the "JFLISTDN" header (key bits at byte 8, value length at 16,
pair count at 48, then a zeroed region of 2 * (4 + 8 * key_bits) bytes
after 72), then packed little-endian (key, 4-byte value) pairs
(krakendb.cpp:60-78)."""

from __future__ import annotations

import numpy as np


def read_pairs(path: str) -> tuple[int, np.ndarray, np.ndarray]:
    """(k, keys uint64 [N], values uint32 [N]) in the file's order."""
    with open(path, "rb") as f:
        head = f.read(56)
    if head[:8] != b"JFLISTDN":
        raise ValueError(f"{path}: not a Kraken database")
    key_bits, val_len = (int(v) for v in np.frombuffer(head, "<u8", 2, 8))
    n = int(np.frombuffer(head, "<u8", 1, 48)[0])
    if val_len != 4:
        raise ValueError(f"{path}: values of {val_len} bytes")
    key_len = (key_bits + 7) // 8
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=72 + 2 * (4 + 8 * key_bits),
                    shape=(n, key_len + 4))
    keys = np.zeros(n, dtype=np.uint64)
    kb = keys.view(np.uint8).reshape(n, 8)
    vals = np.empty(n, dtype=np.uint32)
    step = 1 << 24
    for s in range(0, n, step):
        block = np.asarray(raw[s:s + step])
        kb[s:s + step, :key_len] = block[:, :key_len]
        vals[s:s + step] = block[:, key_len:].copy().view("<u4")[:, 0]
    if key_bits < 64:
        keys &= np.uint64((1 << key_bits) - 1)
    return key_bits // 2, keys, vals
