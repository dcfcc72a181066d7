"""UID (taxon-set) database construction (reference `set_lcas -I`).

Each k-mer's value becomes a UID identifying the exact set of taxa whose
genomes contain it. UIDs are allocated incrementally in scan order
(uid_mapping.cpp:34-86): when a k-mer with current UID u gains a new taxid t,
the candidate set is set(u) + {t} (sets kept sorted ascending); if that set
already has a UID it is reused, otherwise a fresh UID is allocated and the
record (t, u) is appended to the binary `uid_to_taxid.map` (two little-endian
uint32 per UID -- the linked-list encoding read back by classify.uid.UidMap).

Exactness note: the reference calls uid_mapping once per k-mer occurrence,
but a second occurrence of the same k-mer within one sequence is always a
no-op (its taxid is already in the set), so processing only each sequence's
first occurrences -- in scan order -- is byte-identical.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats import write_kdb
from ..formats.counts import counts_from_vals, write_counts
from .db_build import extract_canonical_kmers, resolve_seq_taxid
from ..formats.seqio import read_sequences


def build_uid_database(
    fastas: list[str],
    seqmap: dict[str, int],
    keys: np.ndarray,
    k: int,
    nt: int,
    offsets: np.ndarray,
    db_dir: str | os.PathLike,
    min_sequence_size: int = 0,
) -> int:
    """Build uid_database.kdb + uid_to_taxid.map next to an existing key set.

    `keys` must be the database's key array in its on-disk (bin, k-mer)
    order; `offsets`/`nt` are accepted for signature parity with the index
    but the lookup here is a direct sorted search. Returns the UID count."""
    del nt, offsets  # key order is global; a plain sorted lookup suffices
    keys = np.asarray(keys, dtype=np.uint64)
    sort_perm = np.argsort(keys, kind="stable")
    skeys = keys[sort_perm]

    vals = np.zeros(len(keys), dtype=np.uint32)
    sets_by_uid: list[tuple[int, ...]] = []
    uid_of_set: dict[tuple[int, ...], int] = {}
    chain: list[tuple[int, int]] = []  # (added taxid, parent uid) per new UID

    for path in fastas:
        for dna in read_sequences(path):
            if not dna.seq:
                continue
            taxid = resolve_seq_taxid(dna.id, seqmap)
            if taxid == 0:
                continue
            if min_sequence_size > 0 and len(dna.seq) < min_sequence_size:
                continue
            kms = extract_canonical_kmers(dna.seq, k)
            if len(kms) == 0:
                continue
            # first occurrence per k-mer, in scan order
            _, first = np.unique(kms, return_index=True)
            kms = kms[np.sort(first)]
            pos = np.searchsorted(skeys, kms)
            ok = pos < len(skeys)
            pos = pos[ok]
            kms = kms[ok]
            hit = skeys[pos] == kms
            for slot in sort_perm[pos[hit]].tolist():
                cur = int(vals[slot])
                if cur == 0:
                    tset = (taxid,)
                else:
                    s = sets_by_uid[cur - 1]
                    if taxid in s:
                        continue
                    tset = tuple(sorted(s + (taxid,)))
                uid = uid_of_set.get(tset)
                if uid is None:
                    uid = len(sets_by_uid) + 1
                    uid_of_set[tset] = uid
                    sets_by_uid.append(tset)
                    chain.append((taxid, cur))
                vals[slot] = uid

    write_kdb(os.path.join(db_dir, "uid_database.kdb"), keys, vals, k=k)
    flat = np.asarray(chain, dtype=np.uint32).reshape(-1).astype("<u4")
    flat.tofile(os.path.join(db_dir, "uid_to_taxid.map"))
    write_counts(
        os.path.join(db_dir, "uid_database.kdb.counts"), counts_from_vals(vals)
    )
    return len(sets_by_uid)
