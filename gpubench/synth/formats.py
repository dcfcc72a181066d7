"""Writers of a Kraken database directory, frozen for the benchmark:
`database.kdb` (krakendb.cpp:60-78: the "JFLISTDN" header, key bits at
byte 8, value length 4 at 16, pair count at 48, a zeroed region to
72 + 2 * (4 + 8 * key_bits), then little-endian (key, value) pairs),
`database.idx` (krakendb.cpp:534-544: "KRAKIX2", nt, then 4^nt + 1 u64 bin
offsets) and `taxDB` (taxdb.hpp:533-547: taxid, parent, name, rank a line,
by taxid)."""

from __future__ import annotations

import numpy as np


def write_kdb(path: str, keys: np.ndarray, vals: np.ndarray, k: int, block: int = 1 << 24) -> None:
    key_bits = 2 * k
    key_len = (key_bits + 7) // 8
    n = len(keys)
    header = bytearray(72 + 2 * (4 + 8 * key_bits))
    header[:8] = b"JFLISTDN"
    header[8:16] = np.uint64(key_bits).tobytes()
    header[16:24] = np.uint64(4).tobytes()
    header[48:56] = np.uint64(n).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(header))
        for s in range(0, n, block):
            kb = np.ascontiguousarray(keys[s:s + block], dtype="<u8")
            vb = np.ascontiguousarray(vals[s:s + block], dtype="<u4")
            pair = np.empty((len(kb), key_len + 4), dtype=np.uint8)
            pair[:, :key_len] = kb.view(np.uint8).reshape(-1, 8)[:, :key_len]
            pair[:, key_len:] = vb.view(np.uint8).reshape(-1, 4)
            f.write(pair.tobytes())


def write_index(path: str, nt: int, offsets: np.ndarray) -> None:
    offsets = np.ascontiguousarray(offsets, dtype="<u8")
    if len(offsets) != (1 << (2 * nt)) + 1:
        raise ValueError(f"need 4^{nt} + 1 offsets, got {len(offsets)}")
    with open(path, "wb") as f:
        f.write(b"KRAKIX2" + bytes([nt]))
        f.write(offsets.tobytes())


def write_taxdb(path: str, taxids, parents, names, ranks) -> None:
    order = np.argsort(np.asarray(taxids, dtype=np.int64), kind="stable")
    with open(path, "w") as f:
        f.writelines(f"{taxids[i]}\t{parents[i]}\t{names[i]}\t{ranks[i]}\n" for i in order.tolist())
