"""HyperLogLog++ with sparse/dense modes, bit-exact to the reference class
(src/hyperloglogplus.{hpp,cpp}) so unique-k-mer report columns match.

Key semantics replicated:
  * murmur3-finalizer bit mixing with key+1 (done on device; this class
    consumes 32-bit sparse ENCODINGS, which are a sufficient statistic for
    both sparse insertion and dense register updates -- see
    utils/bits.encode_hash_32/decode_rank)
  * sparse mode: a SET of 32-bit encodings at pPrime=25
    (hyperloglogplus.cpp:239-244, unordered_set specialization)
  * sparse->dense switch when size+1 > m/4, checked before each insert
    (hyperloglogplus.cpp:496-498); batched here by locating the first insert
    position at which the distinct count reaches m/4
  * merge rules (hyperloglogplus.cpp:586-665): empty adopts other;
    sparse U sparse stays sparse with NO size check; any dense wins
  * estimators: Ertl (default, :722-753), Heule (:756-796, empirical bias
    tables from Heule et al. 2013 stored as data in heule_bias_data.npz),
    Flajolet (:679-708); all clamped to n_observed (:84, :752)

The classifier's per-work-unit accumulation (classify.cpp:525-543) is
mirrored by the driver: a fresh unit-local HLL per taxon per work unit,
merged into the global state in unit order, making sparse/dense transitions
(and thus reports) bit-reproducible.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..utils.bits import P_PRIME, M_PRIME, decode_rank, encode_hash_32, murmur3_finalizer

_BIAS_PATH = os.path.join(os.path.dirname(__file__), "heule_bias_data.npz")
_bias_data = None
# entries of both sparse sets fed to each np.union1d of HLL.merge, over the
# process: the report's "report.aggregate" span counts the rise over its
# interval (a plain add a merge, not a recorder call)
union_entries = 0


def _load_bias():
    global _bias_data
    if _bias_data is None:
        _bias_data = np.load(_BIAS_PATH)
    return _bias_data


def _sigma(x: float) -> float:
    """Ertl zero-register correction (hyperloglogplus.cpp:373-387)."""
    if x == 1.0:
        return math.inf
    sigma_x = x
    y = 1.0
    while True:
        prev = sigma_x
        x *= x
        sigma_x += x * y
        y += y
        if sigma_x == prev:
            return sigma_x


def _tau(x: float) -> float:
    """Ertl saturated-register correction (hyperloglogplus.cpp:408-422)."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    tau_x = 1.0 - x
    while True:
        prev = tau_x
        x = math.sqrt(x)
        y /= 2.0
        tau_x -= (1.0 - x) ** 2 * y
        if tau_x == prev:
            return tau_x / 3.0


def _cpp_round(x: float) -> int:
    """C++ round(): half away from zero (values here are non-negative)."""
    return int(math.floor(x + 0.5))


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / float(m))


class HLL:
    """Per-taxon HLL state. Consumes 32-bit sparse encodings (see module doc)."""

    __slots__ = ("p", "m", "sparse", "sparse_set", "M", "n_observed", "use_n_observed")

    def __init__(self, p: int = 12, sparse: bool = True):
        if p < 4 or p > 18:
            raise ValueError("precision must be between 4 and 18")
        self.p = p
        self.m = 1 << p
        self.sparse = sparse
        self.sparse_set: np.ndarray = np.empty(0, dtype=np.uint32)  # sorted unique
        self.M: np.ndarray | None = None if sparse else np.zeros(self.m, dtype=np.uint8)
        self.n_observed = 0
        self.use_n_observed = True

    # ------------------------------------------------------------- insertion

    def insert_hashes(self, hashes: np.ndarray) -> None:
        """Insert pre-mixed 64-bit hash values (in order)."""
        self.insert_encodings(encode_hash_32(hashes, self.p))

    def insert_items(self, items: np.ndarray) -> None:
        self.insert_hashes(murmur3_finalizer(np.asarray(items, dtype=np.uint64)))

    def insert_encodings(self, encs: np.ndarray) -> None:
        """Insert encodings preserving the reference's one-at-a-time switch
        semantics, vectorized."""
        encs = np.asarray(encs, dtype=np.uint32)
        n = len(encs)
        if n == 0:
            return
        self.n_observed += n
        if not self.sparse:
            self._registers_max(encs)
            return

        threshold = self.m // 4
        current = len(self.sparse_set)
        uniq, first_idx = np.unique(encs, return_index=True)
        new_mask = ~np.isin(uniq, self.sparse_set, assume_unique=True)
        new_first = np.sort(first_idx[new_mask])
        k_new = len(new_first)

        if current >= threshold:
            go_dense = True
        elif current + k_new > threshold:
            go_dense = True
        elif current + k_new == threshold and k_new > 0 and new_first[-1] < n - 1:
            # the set fills exactly at a non-final insert; the next insert
            # triggers the switch within this batch
            go_dense = True
        else:
            go_dense = False

        if go_dense:
            self.sparse = False
            self.M = np.zeros(self.m, dtype=np.uint8)
            if len(self.sparse_set):
                self._registers_max(self.sparse_set)
            self.sparse_set = np.empty(0, dtype=np.uint32)
            self._registers_max(encs)
        else:
            self.sparse_set = np.union1d(self.sparse_set, uniq[new_mask])

    def _registers_max(self, encs: np.ndarray) -> None:
        idx = (encs >> np.uint32(32 - self.p)).astype(np.int64)
        rank = decode_rank(encs, self.p)
        np.maximum.at(self.M, idx, rank)

    # ----------------------------------------------------------------- merge

    def merge(self, other: "HLL") -> None:
        """Reference merge semantics (hyperloglogplus.cpp:586-665)."""
        global union_entries
        if self.p != other.p:
            raise ValueError("precisions must be equal")
        if other.n_observed == 0:
            return
        if self.n_observed == 0:
            self.n_observed = other.n_observed
            self.sparse = other.sparse
            self.sparse_set = other.sparse_set.copy()
            self.M = None if other.M is None else other.M.copy()
            return
        self.n_observed += other.n_observed
        if self.sparse and other.sparse:
            union_entries += len(self.sparse_set) + len(other.sparse_set)
            self.sparse_set = np.union1d(self.sparse_set, other.sparse_set)
        elif other.sparse:
            if len(other.sparse_set):
                self._registers_max(other.sparse_set)
        else:
            if self.sparse:
                self.sparse = False
                self.M = other.M.copy()
                if len(self.sparse_set):
                    self._registers_max(self.sparse_set)
                self.sparse_set = np.empty(0, dtype=np.uint32)
            else:
                np.maximum(self.M, other.M, out=self.M)

    def copy(self) -> "HLL":
        out = HLL(self.p)
        out.sparse = self.sparse
        out.sparse_set = self.sparse_set.copy()
        out.M = None if self.M is None else self.M.copy()
        out.n_observed = self.n_observed
        return out

    # ------------------------------------------------------------ estimators

    def _hist(self) -> tuple[np.ndarray, int, int]:
        """Register-value histogram, q, m (hyperloglogplus.cpp:337-366).

        Sparse-mode ranks above q+1 are dropped, matching the observable
        behavior of the reference (whose fixed-size histogram cannot
        represent them)."""
        if self.sparse:
            q = 64 - P_PRIME
            m = M_PRIME
            ranks = decode_rank(self.sparse_set, self.p)
            hist = np.bincount(ranks, minlength=66)
            hist[0] = m - len(self.sparse_set)
        else:
            q = 64 - self.p
            m = self.m
            hist = np.bincount(self.M, minlength=66)
        return hist, q, m

    def ertl_cardinality(self) -> int:
        """Ertl 2017 estimator (hyperloglogplus.cpp:722-753)."""
        hist, q, m = self._hist()
        den = m * _tau(1.0 - float(hist[q + 1]) / float(m))
        for k in range(q, 0, -1):
            den += float(hist[k])
            den *= 0.5
        den += m * _sigma(float(hist[0]) / float(m))
        m_sq_alpha_inf = (m / (2.0 * math.log(2.0))) * m
        est = m_sq_alpha_inf / den
        if self.use_n_observed and self.n_observed < est:
            return self.n_observed
        return _cpp_round(est)

    def heule_cardinality(self, correct_bias: bool = True) -> int:
        """Heule et al. 2015 estimator (hyperloglogplus.cpp:756-796)."""
        if self.p > 18:
            return self.ertl_cardinality()
        if self.sparse:
            v = M_PRIME - len(self.sparse_set)
            return _cpp_round(M_PRIME * math.log(M_PRIME / float(v)))
        v = int(np.count_nonzero(self.M == 0))
        data = _load_bias()
        if v != 0:
            lc = _cpp_round(self.m * math.log(self.m / float(v)))
            if lc <= float(data["thresholds"][self.p - 4]):
                return lc
        est = self._raw_estimate()
        if correct_bias and est <= self.m * 5.0:
            est -= self._estimate_bias(est)
        if self.use_n_observed and self.n_observed < est:
            return self.n_observed
        return _cpp_round(est)

    def flajolet_cardinality(self, use_sparse_precision: bool = True) -> int:
        """Flajolet LogLog with linear-counting switch (hyperloglogplus.cpp:679-708)."""
        if self.sparse and use_sparse_precision:
            v = M_PRIME - len(self.sparse_set)
            return _cpp_round(M_PRIME * math.log(M_PRIME / float(v)))
        if self.sparse:
            m_arr = np.zeros(self.m, dtype=np.uint8)
            idx = (self.sparse_set >> np.uint32(32 - self.p)).astype(np.int64)
            rank = decode_rank(self.sparse_set, self.p)
            np.maximum.at(m_arr, idx, rank)
        else:
            m_arr = self.M
        inv_sum = float(np.sum(np.ldexp(1.0, -m_arr.astype(np.int64))))
        est = _alpha(len(m_arr)) * float(len(m_arr)) ** 2 / inv_sum
        if est <= 2.5 * len(m_arr):
            v = int(np.count_nonzero(m_arr == 0))
            if v > 0:
                est = len(m_arr) * math.log(len(m_arr) / float(v))
        if self.use_n_observed and self.n_observed < est:
            return self.n_observed
        return _cpp_round(est)

    def _raw_estimate(self) -> float:
        inv_sum = float(np.sum(np.ldexp(1.0, -self.M.astype(np.int64))))
        return _alpha(self.m) * float(self.m) * float(self.m) / inv_sum

    def _estimate_bias(self, est: float) -> float:
        data = _load_bias()
        raw = data[f"raw_{self.p}"]
        bias = data[f"bias_{self.p}"]
        if raw[0] >= est:
            return float(bias[0])
        if raw[-1] <= est:
            return float(bias[-1])
        pos = int(np.searchsorted(raw, est, side="left"))
        e1, e2 = raw[pos - 1], raw[pos]
        c = (est - e1) / (e2 - e1)
        return float(bias[pos - 1] * (1 - c) + bias[pos] * c)

    def cardinality(self) -> int:
        return self.ertl_cardinality()


class ExactCounter:
    """khset64-equivalent exact distinct-k-mer counter (--exact mode,
    classify.cpp:44-56): stores the canonical k-mers themselves."""

    __slots__ = ("kmers",)

    def __init__(self):
        self.kmers = np.empty(0, dtype=np.uint64)

    def insert_items(self, items: np.ndarray) -> None:
        self.kmers = np.union1d(self.kmers, np.asarray(items, dtype=np.uint64))

    def merge(self, other: "ExactCounter") -> None:
        self.kmers = np.union1d(self.kmers, other.kmers)

    def copy(self) -> "ExactCounter":
        out = ExactCounter()
        out.kmers = self.kmers.copy()
        return out

    def cardinality(self) -> int:
        return len(self.kmers)


class ReadCounts:
    """Per-taxon {n_reads, n_kmers, unique-k-mer container}
    (reference src/readcounts.hpp:31-106)."""

    __slots__ = ("n_reads", "n_kmers", "kmers")

    def __init__(self, container=None):
        self.n_reads = 0
        self.n_kmers = 0
        self.kmers = container

    def increment_read_count(self) -> None:
        self.n_reads += 1

    def unique_kmer_count(self) -> int:
        return 0 if self.kmers is None else self.kmers.cardinality()

    def iadd(self, other: "ReadCounts") -> "ReadCounts":
        self.n_reads += other.n_reads
        self.n_kmers += other.n_kmers
        if other.kmers is not None:
            if self.kmers is None:
                self.kmers = other.kmers.copy()
            else:
                self.kmers.merge(other.kmers)
        return self

    def copy(self) -> "ReadCounts":
        out = ReadCounts(None if self.kmers is None else self.kmers.copy())
        out.n_reads = self.n_reads
        out.n_kmers = self.n_kmers
        return out

    def sort_key(self):
        """Sibling ordering in reports (readcounts.hpp:90-98): by n_reads,
        then n_kmers."""
        return (self.n_reads, self.n_kmers)
