"""UID (taxon-set) database support, classify side.

A UID database stores, per k-mer, an identifier of the exact SET of taxa
whose genomes contain it (reference src/uid_mapping.{hpp,cpp}). The
`uid_to_taxid.map` binary file is a linked list: record i (1-based UID,
8 bytes) = (taxid uint32, parent_uid uint32); UID i's taxon set is its
taxid plus the chain of parents (uid_mapping.cpp:278-300).

Read calls are resolved by resolve_uids3 semantics (uid_mapping.cpp:212-274):
per-taxid raw counts (sum of UID hit counts over sets containing the taxid)
and fractional counts (hits / |set|); winner by raw count, ties by
fractional count, remaining ties by LCA fold.
"""

from __future__ import annotations

import os

import numpy as np


class UidMap:
    def __init__(self, path: str | os.PathLike):
        raw = np.fromfile(path, dtype="<u4")
        self.taxids = raw[0::2].copy()
        self.parents = raw[1::2].copy()
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.taxids)

    def taxid_set(self, uid: int) -> np.ndarray:
        """Taxids for a UID in chain order (uid_mapping.cpp:278-300)."""
        cached = self._cache.get(uid)
        if cached is not None:
            return cached
        out = []
        u = uid
        while u != 0:
            out.append(int(self.taxids[u - 1]))
            u = int(self.parents[u - 1])
        arr = np.asarray(out, dtype=np.uint32)
        self._cache[uid] = arr
        return arr


def resolve_uids(
    uid_hit_counts: dict[int, int],
    uid_map: UidMap,
    lca_fold,
) -> int:
    """resolve_uids3 semantics; `lca_fold(list[int]) -> int` folds ties."""
    if not uid_hit_counts:
        return 0
    taxid_counts: dict[int, int] = {}
    frac_counts: dict[int, float] = {}
    for uid, count in uid_hit_counts.items():
        if uid == 0:
            continue
        taxids = uid_map.taxid_set(uid)
        frac = float(count) / float(len(taxids))
        for t in taxids.tolist():
            taxid_counts[t] = taxid_counts.get(t, 0) + count
            frac_counts[t] = frac_counts.get(t, 0.0) + frac
    if not taxid_counts:
        return 0
    max_taxids: list[int] = []
    max_count = 0
    max_frac = 0.0
    for t, c in taxid_counts.items():
        if c == max_count:
            if frac_counts[t] == max_frac:
                max_taxids.append(t)
            elif frac_counts[t] > max_frac:
                max_frac = frac_counts[t]
                max_taxids = [t]
        elif c > max_count:
            max_taxids = [t]
            max_count = c
            max_frac = frac_counts[t]
    if len(max_taxids) == 1:
        return max_taxids[0]
    return lca_fold(max_taxids)
