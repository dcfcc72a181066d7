"""The HLL++ estimate the report prints, frozen for the benchmark.

A copy of KrakenUniq's default estimator (Ertl 2017, hyperloglogplus.cpp:
373-422 and 722-753) over the two states a taxon's counter ends in: a sparse
set of 32-bit encodings at precision 25, or 2^p dense registers. Both are
clamped to the number of k-mers observed (hyperloglogplus.cpp:84, 752).
"""

from __future__ import annotations

import math

import numpy as np

from .kmers import P_PRIME, decode_rank


def _sigma(x: float) -> float:
    if x == 1.0:
        return math.inf
    sigma_x, y = x, 1.0
    while True:
        prev = sigma_x
        x *= x
        sigma_x += x * y
        y += y
        if sigma_x == prev:
            return sigma_x


def _tau(x: float) -> float:
    if x == 0.0 or x == 1.0:
        return 0.0
    y, tau_x = 1.0, 1.0 - x
    while True:
        prev = tau_x
        x = math.sqrt(x)
        y /= 2.0
        tau_x -= (1.0 - x) ** 2 * y
        if tau_x == prev:
            return tau_x / 3.0


def _ertl(hist: np.ndarray, q: int, m: int, n_observed: int) -> int:
    den = m * _tau(1.0 - float(hist[q + 1]) / float(m))
    for k in range(q, 0, -1):
        den += float(hist[k])
        den *= 0.5
    den += m * _sigma(float(hist[0]) / float(m))
    est = (m / (2.0 * math.log(2.0))) * m / den
    if n_observed < est:
        return int(n_observed)
    return int(math.floor(est + 0.5))  # C++ round() of a non-negative value


def estimate_sparse(encs: np.ndarray, p: int, n_observed: int) -> int:
    """A counter still sparse: its distinct encodings; ranks past the
    histogram's q + 1 are dropped, as the reference's fixed histogram drops
    them."""
    hist = np.bincount(decode_rank(encs, p), minlength=66)
    hist[0] = (1 << P_PRIME) - len(encs)
    return _ertl(hist, 64 - P_PRIME, 1 << P_PRIME, n_observed)


def estimate_dense(registers: np.ndarray, n_observed: int) -> int:
    m = len(registers)
    hist = np.bincount(registers, minlength=66)
    return _ertl(hist, 64 - (m.bit_length() - 1), m, n_observed)


def registers_of(encs: np.ndarray, p: int) -> np.ndarray:
    """The 2^p dense registers of a set of encodings."""
    reg = np.zeros(1 << p, dtype=np.uint8)
    if len(encs):
        np.maximum.at(reg, (np.asarray(encs, np.uint32) >> np.uint32(32 - p)).astype(np.int64),
                      decode_rank(encs, p))
    return reg
