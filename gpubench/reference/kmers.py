"""K-mer and HLL bit arithmetic in NumPy, frozen for the benchmark.

A copy of the semantics the classifier's outputs must follow (KrakenUniq:
krakendb.cpp:182-246 for the canonical k-mer and the scrambled minimizer,
hyperloglogplus.cpp:107-204 and 830-838 for the HLL hash and its sparse
encoding). The benchmark keeps its own copy so that an edit to the program's
helpers cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

INDEX2_XOR_MASK = 0xE37E28C4271B5A2D  # krakendb.cpp:45
P_PRIME = 25  # sparse precision (hyperloglogplus.hpp:76)

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)
_U1 = np.uint64(1)


def reverse_complement(kmer: np.ndarray, n: int) -> np.ndarray:
    """Reverse complement of 2-bit packed n-mers."""
    x = np.asarray(kmer, dtype=np.uint64)
    x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M8) | ((x & _M8) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M16) | ((x & _M16) << np.uint64(16))
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    return (~x) >> np.uint64(64 - 2 * n)


def canonical(kmer: np.ndarray, n: int) -> np.ndarray:
    kmer = np.asarray(kmer, dtype=np.uint64)
    return np.minimum(kmer, reverse_complement(kmer, n))


def bin_key(kmer: np.ndarray, k: int, nt: int) -> np.ndarray:
    """Scrambled minimizer of canonical k-mers: the least of
    XOR_MASK ^ canonical(m-mer) over the k - nt + 1 m-mers."""
    x = np.asarray(kmer, dtype=np.uint64)
    mask = (_U1 << np.uint64(2 * nt)) - _U1
    xm = np.uint64(INDEX2_XOR_MASK) & mask
    best = np.full(x.shape, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    for _ in range(k - nt + 1):
        np.minimum(best, xm ^ canonical(x & mask, nt), out=best)
        x = x >> np.uint64(2)
    return best


def murmur3_finalizer(key: np.ndarray) -> np.ndarray:
    """The HLL hash: murmur3's 64-bit finalizer of key + 1."""
    h = np.asarray(key, dtype=np.uint64) + _U1
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


def _bit_length32(v: np.ndarray) -> np.ndarray:
    """Bit length of values below 2^32, exact through float64's exponent."""
    return np.frexp(np.asarray(v, dtype=np.float64))[1].astype(np.int64)


def _clz(x: np.ndarray, bits: int) -> np.ndarray:
    """Leading zeros of `bits`-bit values (clz(0) == bits)."""
    x = np.asarray(x).astype(np.uint64)
    if bits == 32:
        return 32 - _bit_length32(x)
    hi = x >> np.uint64(32)
    lo = x & np.uint64(0xFFFFFFFF)
    return np.where(hi != 0, 32 - _bit_length32(hi), 64 - _bit_length32(lo))


def encode_hash_32(h: np.ndarray, p: int) -> np.ndarray:
    """Sparse 32-bit encoding of a 64-bit hash (hyperloglogplus.cpp:181-204):
    the top 25 bits at 31..7; where the bits between the dense index and the
    sparse index are all 0, also the rank in the low 39 bits at 6..1 and flag
    bit 0."""
    h = np.asarray(h, dtype=np.uint64)
    idx = ((h >> np.uint64(64 - P_PRIME)) << np.uint64(32 - P_PRIME)).astype(np.uint32)
    flagged = (idx << np.uint32(p)) == 0
    shifted = h << np.uint64(P_PRIME)
    rank = (np.minimum(_clz(shifted, 64), 64 - P_PRIME) + 1).astype(np.uint32)
    return np.where(flagged, idx | (rank << np.uint32(1)) | np.uint32(1), idx).astype(np.uint32)


def decode_rank(enc: np.ndarray, p: int) -> np.ndarray:
    """The dense register's rank of a sparse encoding (hyperloglogplus.cpp:152-161)."""
    enc = np.asarray(enc, dtype=np.uint32)
    flagged = (enc & np.uint32(1)) == 1
    stored = ((enc >> np.uint32(1)) & np.uint32(0x3F)).astype(np.int64) + (P_PRIME - p)
    shifted = (enc << np.uint32(p)).astype(np.uint32)
    plain = np.minimum(_clz(shifted, 32), 32 - p) + 1
    return np.where(flagged, stored, plain).astype(np.uint8)


def pack_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 [n, L - k + 1]: every k-base window of 2-bit codes [n, L],
    first base highest, built by doubling (windows of m bases give those of
    2m) instead of k shifts."""
    n, length = codes.shape
    w = length - k + 1
    part = codes.astype(np.uint64)  # windows of m bases, starting at each column
    m = 1
    out, r = None, 0  # windows of r bases, the bits of k taken so far
    while True:
        if k & m:
            cols = length - (r + m) + 1
            if out is None:
                out = part[:, :cols].copy()
            else:
                out = (out[:, :cols] << np.uint64(2 * m)) | part[:, r:r + cols]
            r += m
        if 2 * m > k:
            break
        cols = length - 2 * m + 1
        part = (part[:, :cols] << np.uint64(2 * m)) | part[:, m:m + cols]
        m *= 2
    return np.ascontiguousarray(out[:, :w])


def read_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mers uint64 [n, W] and ambiguity bool [n, W] of reads
    [n, L] coded 0-3 for ACGT and 4 for any other base: a window is
    ambiguous when it holds such a base."""
    n, length = codes.shape
    w = length - k + 1
    c = np.minimum(codes, 3).astype(np.uint8)
    fwd = pack_windows(c, k)
    rc = pack_windows(3 - c[:, ::-1], k)[:, ::-1]
    canon = np.minimum(fwd, rc)
    bad = np.zeros((n, length + 1), dtype=np.int32)
    np.cumsum(codes > 3, axis=1, out=bad[:, 1:])
    ambig = (bad[:, k:] - bad[:, :w]) > 0
    return canon, ambig
