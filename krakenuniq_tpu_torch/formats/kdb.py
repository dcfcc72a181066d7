"""Jellyfish-v1 / Kraken database (.kdb / .jdb) container format.

Layout (reference src/krakendb.cpp:60-78, 177):
  bytes 0..7    magic "JFLISTDN"
  u64 @ 8       key_bits   (2 bits per base => k = key_bits / 2)
  u64 @ 16      val_len    (always 4)
  u64 @ 48      key_ct     (number of key/value pairs)
  header size = 72 + 2 * (4 + 8 * key_bits)   (Jellyfish hash-matrix region;
                zero-filled by our writer, never read by the classifier)
  then key_ct packed little-endian (key, value) pairs;
  key occupies key_len = ceil(key_bits / 8) bytes, value 4 bytes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

KRAKEN_DB_MAGIC = b"JFLISTDN"


@dataclasses.dataclass(frozen=True)
class KdbHeader:
    key_bits: int
    val_len: int
    key_ct: int

    @property
    def k(self) -> int:
        return self.key_bits // 2

    @property
    def key_len(self) -> int:
        return self.key_bits // 8 + (1 if self.key_bits % 8 else 0)

    @property
    def pair_size(self) -> int:
        return self.key_len + self.val_len

    @property
    def header_size(self) -> int:
        return 72 + 2 * (4 + 8 * self.key_bits)


def read_header(path: str | os.PathLike) -> KdbHeader:
    with open(path, "rb") as f:
        head = f.read(56)
    if head[:8] != KRAKEN_DB_MAGIC:
        raise ValueError(f"{path}: not a Kraken database (bad magic {head[:8]!r})")
    key_bits = int(np.frombuffer(head, dtype="<u8", count=1, offset=8)[0])
    val_len = int(np.frombuffer(head, dtype="<u8", count=1, offset=16)[0])
    key_ct = int(np.frombuffer(head, dtype="<u8", count=1, offset=48)[0])
    if val_len != 4:
        raise ValueError(f"{path}: only 4-byte values supported (got {val_len})")
    return KdbHeader(key_bits=key_bits, val_len=val_len, key_ct=key_ct)


def read_kdb(path: str | os.PathLike, mmap: bool = True):
    """Read a .kdb/.jdb file -> (header, keys u64[N], vals u32[N]).

    Keys are the 2-bit packed canonical k-mers, zero-extended to uint64 and
    masked to key_bits (mirroring the `comp_kmer &= (1<<key_bits)-1` trim in
    krakendb.cpp:284).
    """
    hdr = read_header(path)
    if mmap:
        raw = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        raw = np.fromfile(path, dtype=np.uint8)
    pairs = raw[hdr.header_size : hdr.header_size + hdr.key_ct * hdr.pair_size]
    pairs = pairs.reshape(hdr.key_ct, hdr.pair_size)
    key_bytes = np.zeros((hdr.key_ct, 8), dtype=np.uint8)
    key_bytes[:, : hdr.key_len] = pairs[:, : hdr.key_len]
    keys = key_bytes.view("<u8").reshape(hdr.key_ct)
    if hdr.key_bits < 64:
        keys = keys & ((np.uint64(1) << np.uint64(hdr.key_bits)) - np.uint64(1))
    vals = (
        pairs[:, hdr.key_len : hdr.key_len + 4]
        .copy()
        .view("<u4")
        .reshape(hdr.key_ct)
    )
    return hdr, keys, vals


def kdb_header_bytes(hdr: KdbHeader) -> bytes:
    """The on-disk header for `hdr` (key_ct at offset 48, Jellyfish region
    zero-filled). Shared by write_kdb and the streaming builder so the
    layout lives in exactly one place."""
    header = bytearray(hdr.header_size)
    header[:8] = KRAKEN_DB_MAGIC
    header[8:16] = np.uint64(hdr.key_bits).tobytes()
    header[16:24] = np.uint64(hdr.val_len).tobytes()
    header[48:56] = np.uint64(hdr.key_ct).tobytes()
    return bytes(header)


def pack_pairs(hdr: KdbHeader, keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Pack parallel key/value arrays into the kdb's on-disk pair records
    (key_len little-endian key bytes + val_len value bytes per row)."""
    keys = np.ascontiguousarray(keys, dtype="<u8")
    vals = np.ascontiguousarray(vals, dtype="<u4")
    if keys.shape != vals.shape:
        raise ValueError("keys and vals must have the same length")
    pair = np.zeros((len(keys), hdr.pair_size), dtype=np.uint8)
    pair[:, : hdr.key_len] = keys.view(np.uint8).reshape(-1, 8)[:, : hdr.key_len]
    pair[:, hdr.key_len : hdr.key_len + 4] = vals.view(np.uint8).reshape(-1, 4)
    return pair


def write_kdb(
    path: str | os.PathLike,
    keys: np.ndarray,
    vals: np.ndarray,
    k: int,
) -> KdbHeader:
    """Write keys/vals as a reference-compatible .kdb file."""
    hdr = KdbHeader(key_bits=2 * k, val_len=4, key_ct=len(keys))
    pair = pack_pairs(hdr, keys, vals)
    with open(path, "wb") as f:
        f.write(kdb_header_bytes(hdr))
        f.write(pair.tobytes())
    return hdr
