"""Host-side (numpy) bit-exact primitives for k-mer and HLL math.

These define the *semantics contract* of the framework: every device (JAX)
implementation is differential-tested against these functions, and these are
golden-tested against the reference binaries' observable outputs.

Semantics sources (cited for parity checking, no code copied):
  * reverse complement / canonical k-mer: reference src/krakendb.cpp:218-246
  * scrambled minimizer ("bin key"):      reference src/krakendb.cpp:182-215
  * murmur3 finalizer (with key+=1):      reference src/hyperloglogplus.cpp:830-838
  * rank/index/sparse-encoding helpers:   reference src/hyperloglogplus.cpp:107-204

All functions are vectorized over numpy uint64 arrays.
"""

from __future__ import annotations

import numpy as np

# XOR mask applied to canonical m-mers before taking the minimum: scrambles
# the minimizer ordering so bins are load-balanced (krakendb.cpp:45).
INDEX2_XOR_MASK = np.uint64(0xE37E28C4271B5A2D)

_U64_1 = np.uint64(1)
_U64_64 = np.uint64(64)

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)


def reverse_complement(kmer: np.ndarray, n: int) -> np.ndarray:
    """Reverse complement of 2-bit packed k-mers of length n (krakendb.cpp:218-225).

    Works by pairwise swapping 2-bit groups up to a full 64-bit reversal,
    complementing (~x == ~0 - x), then right-aligning to 2n bits.
    """
    kmer = np.asarray(kmer, dtype=np.uint64)
    kmer = ((kmer >> np.uint64(2)) & _M2) | ((kmer & _M2) << np.uint64(2))
    kmer = ((kmer >> np.uint64(4)) & _M4) | ((kmer & _M4) << np.uint64(4))
    kmer = ((kmer >> np.uint64(8)) & _M8) | ((kmer & _M8) << np.uint64(8))
    kmer = ((kmer >> np.uint64(16)) & _M16) | ((kmer & _M16) << np.uint64(16))
    kmer = (kmer >> np.uint64(32)) | (kmer << np.uint64(32))
    return (~kmer) >> np.uint64(64 - (n << 1))


def canonical_representation(kmer: np.ndarray, n: int) -> np.ndarray:
    """min(kmer, revcomp(kmer)) (krakendb.cpp:238-246)."""
    kmer = np.asarray(kmer, dtype=np.uint64)
    rc = reverse_complement(kmer, n)
    return np.minimum(kmer, rc)


def bin_key(kmer: np.ndarray, k: int, nt: int, xor_mask: int | None = None) -> np.ndarray:
    """Scrambled minimizer of a (canonical) k-mer (krakendb.cpp:182-215).

    For each of the k-nt+1 m-mer windows (scanning from the low bits upward),
    compute xor_mask ^ canonical(m-mer) and return the minimum.

    Note: the reference computes the m-mer mask with a 32-bit `1 << (nt*2)`
    (krakendb.cpp:185), which is undefined for nt >= 16; we compute it in
    64-bit, valid for all nt <= 31. Standard DBs use nt = 15.
    """
    kmer = np.asarray(kmer, dtype=np.uint64)
    mask = (_U64_1 << np.uint64(nt * 2)) - _U64_1
    xm = (INDEX2_XOR_MASK if xor_mask is None else np.uint64(xor_mask)) & mask
    min_bin = np.full(kmer.shape, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    for _ in range(k - nt + 1):
        cand = xm ^ canonical_representation(kmer & mask, nt)
        min_bin = np.minimum(min_bin, cand)
        kmer = kmer >> np.uint64(2)
    return min_bin


def murmur3_finalizer(key: np.ndarray) -> np.ndarray:
    """64-bit avalanche mixer used as the HLL hash; adds 1 to the key first so
    hash(0) != 0 (hyperloglogplus.cpp:830-838)."""
    key = np.asarray(key, dtype=np.uint64) + _U64_1
    key ^= key >> np.uint64(33)
    key *= np.uint64(0xFF51AFD7ED558CCD)
    key ^= key >> np.uint64(33)
    key *= np.uint64(0xC4CEB9FE1A85EC53)
    key ^= key >> np.uint64(33)
    return key


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros in uint64 (clz(0) == 64)."""
    x = np.asarray(x, dtype=np.uint64)
    # 64 - bit_length(x); numpy has no clz, emulate via float mantissa tricks
    # being wrong for > 2^53, so use a shift cascade instead.
    n = np.full(x.shape, 64, dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> np.uint64(s)
        take = y != 0
        n = np.where(take, n - s, n)
        x = np.where(take, y, x)
    return (n - x.astype(np.int64)).astype(np.uint64)  # x is 0 or 1 here


def _clz32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    n = np.full(x.shape, 32, dtype=np.int64)
    for s in (16, 8, 4, 2, 1):
        y = x >> np.uint32(s)
        take = y != 0
        n = np.where(take, n - s, n)
        x = np.where(take, y, x)
    return (n - x.astype(np.int64)).astype(np.uint64)


def get_index64(h: np.ndarray, p: int) -> np.ndarray:
    """Dense register index: top p bits of the 64-bit hash (hyperloglogplus.cpp:116)."""
    return (np.asarray(h, dtype=np.uint64) >> np.uint64(64 - p)).astype(np.uint32)


def get_rank64(h: np.ndarray, p: int) -> np.ndarray:
    """Rank = 1 + leading zeros of (h << p), clz saturating at 64-p
    (hyperloglogplus.cpp:140-147)."""
    shifted = np.asarray(h, dtype=np.uint64) << np.uint64(p)
    clz = np.minimum(_clz64(shifted), np.uint64(64 - p))
    return (clz + _U64_1).astype(np.uint8)


def get_index32(enc: np.ndarray, p: int) -> np.ndarray:
    return (np.asarray(enc, dtype=np.uint32) >> np.uint32(32 - p)).astype(np.uint32)


def get_rank32(enc: np.ndarray, p: int) -> np.ndarray:
    shifted = np.asarray(enc, dtype=np.uint32) << np.uint32(p)
    clz = np.minimum(_clz32(shifted), np.uint64(32 - p))
    return (clz + _U64_1).astype(np.uint8)


P_PRIME = 25  # sparse-representation precision (hyperloglogplus.hpp:76)
M_PRIME = 1 << P_PRIME


def encode_hash_32(h: np.ndarray, p: int) -> np.ndarray:
    """Sparse-mode 32-bit encoding of a 64-bit hash (hyperloglogplus.cpp:181-204).

    Layout: top-25 bits of h at bit positions 31..7. If the hash bits between
    the dense index (top p) and the sparse index (top 25) are all zero, the
    encoding additionally stores rank-within-the-low-39-bits in bits 6..1 and
    sets flag bit 0.
    """
    h = np.asarray(h, dtype=np.uint64)
    idx = ((h >> np.uint64(64 - P_PRIME)) << np.uint64(32 - P_PRIME)).astype(np.uint32)
    flagged = (idx << np.uint32(p)).astype(np.uint32) == 0
    additional_rank = get_rank64(h, P_PRIME).astype(np.uint32)
    flagged_enc = idx | (additional_rank << np.uint32(1)) | np.uint32(1)
    return np.where(flagged, flagged_enc, idx).astype(np.uint32)


def decode_rank(enc: np.ndarray, p: int) -> np.ndarray:
    """Dense-relative rank from a sparse encoding (hyperloglogplus.cpp:152-161)."""
    enc = np.asarray(enc, dtype=np.uint32)
    flagged = (enc & np.uint32(1)) == 1
    stored = ((enc >> np.uint32(1)) & np.uint32(0x3F)).astype(np.uint8)
    flag_rank = stored + np.uint8(P_PRIME - p)
    plain_rank = get_rank32(enc, p)
    return np.where(flagged, flag_rank, plain_rank).astype(np.uint8)
