"""Per-taxon read/k-mer/unique-k-mer accumulation (host side).

Mirrors the reference's two-level structure: a fresh per-work-unit
accumulator (thread-local my_taxon_counts, classify.cpp:525-535) merged into
the global map under the output critical section (classify.cpp:542-544).
Keeping the unit structure is what makes sparse->dense HLL transitions, and
therefore the report's unique-k-mer columns, bit-reproducible.

Implementation: the whole unit is folded with ONE sort over packed
(taxon, encoding) pairs instead of per-taxon HLL objects, exploiting that
the reference fold is order-independent given each unit's sparse/dense
decision (see hll.py module doc):

  * a unit-local counter goes dense iff its distinct-encoding count U
    exceeds m/4 -- order-independent except for the U == m/4 boundary
    (the switch fires only if an insert FOLLOWS the one that filled the
    set, hyperloglogplus.cpp:496-498), which is re-checked in stream
    order for exactly those taxa (rare);
  * the final global state per taxon is then either the union of its
    units' distinct encodings (never dense -> sparse set) or the
    register-wise max over all of them (dense) plus summed n_observed --
    both computed by appending per-unit distinct slices to a pending
    list and deduplicating lazily (amortized O(N log N) instead of the
    per-unit set-union the object-per-taxon fold pays).

Exact mode (khset64 semantics, classify.cpp:44-56) is the same pending-list
fold over canonical k-mers with no dense regime.
"""

from __future__ import annotations

import numpy as np

from ..hll import HLL, ExactCounter, ReadCounts
from ..utils.bits import decode_rank


class TaxonCounter:
    def __init__(self, hll_precision: int = 12, exact: bool = False):
        self.hll_precision = hll_precision
        self.m = 1 << hll_precision
        self.exact = exact
        self.n_reads: dict[int, int] = {}
        self.n_kmers: dict[int, int] = {}
        # HLL mode: taxa whose counter went dense in SOME unit -> registers
        self.dense_M: dict[int, np.ndarray] = {}
        # sparse-mode state: per-taxon list of per-unit distinct-encoding
        # slices (u32 encodings; u64 canonical k-mers in exact mode),
        # deduplicated when the appended volume doubles the known set size
        self._pending: dict[int, list[np.ndarray]] = {}
        self._pending_n: dict[int, int] = {}
        self._base_n: dict[int, int] = {}  # distinct count at last compaction
        self._counts_cache: dict[int, ReadCounts] | None = None

    # ------------------------------------------------------------- unit fold

    def process_unit(
        self,
        taxa_flat: np.ndarray,  # uint32 [n]: taxon per counted k-mer, stream order
        enc_flat: np.ndarray,  # uint32 [n]: HLL encoding (or uint64 k-mers if exact)
        calls: np.ndarray,  # uint32 [reads]: per-read call
    ) -> None:
        self._counts_cache = None
        n = len(taxa_flat)
        if n:
            if self.exact:
                self._unit_exact(
                    np.asarray(taxa_flat, np.uint32), np.asarray(enc_flat, np.uint64)
                )
            else:
                self._unit_hll(
                    np.asarray(taxa_flat, np.uint32),
                    np.asarray(enc_flat, np.uint32),
                )
        if len(calls):
            u_calls, c_counts = np.unique(np.asarray(calls, np.uint32), return_counts=True)
            nr = self.n_reads
            for t, c in zip(u_calls.tolist(), c_counts.tolist()):
                nr[t] = nr.get(t, 0) + c

    def _unit_hll(self, taxa_flat: np.ndarray, enc_flat: np.ndarray) -> None:
        pairs = (taxa_flat.astype(np.uint64) << np.uint64(32)) | enc_flat.astype(
            np.uint64
        )
        sp = np.sort(pairs)
        tax_sorted = (sp >> np.uint64(32)).astype(np.int64)
        new_tax = np.empty(len(sp), bool)
        new_tax[0] = True
        np.not_equal(tax_sorted[1:], tax_sorted[:-1], out=new_tax[1:])
        seg_start = np.flatnonzero(new_tax)
        seg_end = np.append(seg_start[1:], len(sp))
        new_pair = np.empty(len(sp), bool)
        new_pair[0] = True
        np.not_equal(sp[1:], sp[:-1], out=new_pair[1:])
        uniq_per_seg = np.add.reduceat(new_pair, seg_start)
        enc_sorted = sp.astype(np.uint32)  # low 32 bits

        th = self.m // 4
        nk, dense_M, pending = self.n_kmers, self.dense_M, self._pending
        for i in range(len(seg_start)):
            s, e = int(seg_start[i]), int(seg_end[i])
            t = int(tax_sorted[s])
            seg_n = e - s
            nk[t] = nk.get(t, 0) + seg_n
            m_t = dense_M.get(t)
            if m_t is not None:
                # global already dense: the unit's contribution reduces to a
                # register-wise max over its distinct encodings regardless of
                # whether the unit counter itself went dense
                self._registers_max(m_t, enc_sorted[s:e][new_pair[s:e]])
                continue
            u = int(uniq_per_seg[i])
            if u > th:
                go_dense = True
            elif u == th:
                # boundary: dense only if an insert follows the one that
                # filled the set -- needs stream order (rare; re-extract)
                stream = enc_flat[taxa_flat == np.uint32(t)]
                _, first_idx = np.unique(stream, return_index=True)
                go_dense = int(first_idx.max()) < len(stream) - 1
            else:
                go_dense = False
            uniq_encs = enc_sorted[s:e][new_pair[s:e]]
            if go_dense:
                m_new = np.zeros(self.m, np.uint8)
                prior = self._drain_pending(t)
                if len(prior):
                    self._registers_max(m_new, prior)
                self._registers_max(m_new, uniq_encs)
                dense_M[t] = m_new
            else:
                pending.setdefault(t, []).append(uniq_encs)
                pn = self._pending_n.get(t, 0) + len(uniq_encs)
                self._pending_n[t] = pn
                if pn > max(8192, 2 * self._base_n.get(t, 0)):
                    self._compact(t)

    def process_sets(self, taxa_flat: np.ndarray, kmers_flat: np.ndarray) -> None:
        """Fold one unit's (taxon, k-mer) stream into the distinct-k-mer sets
        WITHOUT touching read/k-mer counts (--exact with --device-counters:
        the counters live on device; only the khset equivalents fold here)."""
        assert self.exact
        self._counts_cache = None
        if len(taxa_flat):
            self._unit_exact(
                np.asarray(taxa_flat, np.uint32),
                np.asarray(kmers_flat, np.uint64),
                count=False,
            )

    def _unit_exact(
        self, taxa_flat: np.ndarray, kmers_flat: np.ndarray, count: bool = True
    ) -> None:
        order = np.argsort(taxa_flat, kind="stable")
        t_sorted = taxa_flat[order]
        k_sorted = kmers_flat[order]
        new_tax = np.empty(len(t_sorted), bool)
        new_tax[0] = True
        np.not_equal(t_sorted[1:], t_sorted[:-1], out=new_tax[1:])
        seg_start = np.flatnonzero(new_tax)
        seg_end = np.append(seg_start[1:], len(t_sorted))
        nk, pending = self.n_kmers, self._pending
        for i in range(len(seg_start)):
            s, e = int(seg_start[i]), int(seg_end[i])
            t = int(t_sorted[s])
            if count:
                nk[t] = nk.get(t, 0) + (e - s)
            seg = np.unique(k_sorted[s:e])
            pending.setdefault(t, []).append(seg)
            pn = self._pending_n.get(t, 0) + len(seg)
            self._pending_n[t] = pn
            if pn > max(8192, 2 * self._base_n.get(t, 0)):
                self._compact(t)

    # ----------------------------------------------------------- sparse state

    def _drain_pending(self, t: int) -> np.ndarray:
        parts = self._pending.pop(t, None)
        self._pending_n.pop(t, None)
        self._base_n.pop(t, None)
        if not parts:
            return np.empty(0, np.uint64 if self.exact else np.uint32)
        if len(parts) == 1:
            return parts[0]  # per-unit slices are sorted-unique by construction
        return np.unique(np.concatenate(parts))

    def _compact(self, t: int) -> None:
        merged = self._drain_pending(t)
        self._pending[t] = [merged]
        self._pending_n[t] = len(merged)
        self._base_n[t] = len(merged)

    def _registers_max(self, m_arr: np.ndarray, encs: np.ndarray) -> None:
        if not len(encs):
            return
        idx = (encs >> np.uint32(32 - self.hll_precision)).astype(np.int64)
        rank = decode_rank(encs, self.hll_precision)
        np.maximum.at(m_arr, idx, rank)

    # --------------------------------------------------------------- finalize

    @property
    def counts(self) -> dict[int, ReadCounts]:
        """The global taxon_counts map as {taxid: ReadCounts}; built lazily
        from the fold state (non-destructive -- more units may follow)."""
        if self._counts_cache is not None:
            return self._counts_cache
        out: dict[int, ReadCounts] = {}
        taxa = (
            set(self.n_reads) | set(self.n_kmers)
            | set(self._pending) | set(self.dense_M)
        )
        for t in taxa:
            nk = self.n_kmers.get(t, 0)
            if self.exact:
                cont = ExactCounter()
                parts = self._pending.get(t)
                if parts:
                    cont.kmers = np.unique(np.concatenate(parts))
            else:
                m_t = self.dense_M.get(t)
                if m_t is not None:
                    cont = HLL(self.hll_precision, sparse=False)
                    cont.M = m_t.copy()
                else:
                    cont = HLL(self.hll_precision)
                    parts = self._pending.get(t)
                    if parts:
                        cont.sparse_set = (
                            np.unique(np.concatenate(parts))
                            if len(parts) > 1
                            else parts[0].copy()
                        )
                cont.n_observed = nk
            rc = ReadCounts(cont)
            rc.n_kmers = nk
            rc.n_reads = self.n_reads.get(t, 0)
            out[t] = rc
        self._counts_cache = out
        return out
