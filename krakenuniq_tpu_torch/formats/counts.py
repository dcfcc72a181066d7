"""Per-taxon k-mer count sidecar file (`database.kdb.counts`).

Text lines `taxid\tcount`, sorted by taxid (the reference builds it from a
std::map scan over the whole DB, classify.cpp:276-283 / krakendb.cpp:90-113).
"""

from __future__ import annotations

import os

import numpy as np


def read_counts(path: str | os.PathLike) -> dict[int, int]:
    out: dict[int, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            taxid, count = line.split("\t")
            out[int(taxid)] = int(count)
    return out


def write_counts(path: str | os.PathLike, counts: dict[int, int]) -> None:
    with open(path, "w") as f:
        for taxid in sorted(counts):
            f.write(f"{taxid}\t{counts[taxid]}\n")


def counts_from_vals(vals: np.ndarray) -> dict[int, int]:
    """Taxon histogram over the DB value column (krakendb.cpp:90-113)."""
    uniq, cnt = np.unique(np.asarray(vals), return_counts=True)
    return {int(t): int(c) for t, c in zip(uniq, cnt)}


def read_counts_stream_bugcompat(path: str | os.PathLike) -> list[tuple[int, int]]:
    """Counts as consumed by the reference's readGenomeSizes (taxdb.hpp:867-885).

    Its `while (!eof) { in >> taxid >> size; setGenomeSize(...); }` loop
    processes the final line twice when the file ends with a newline (the
    failed extraction leaves the previous values in place), so the last
    taxon's genome size is double-counted. Replicated here for report
    equality."""
    pairs: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        data = f.read()
    for line in data.decode().splitlines():
        line = line.strip()
        if line:
            taxid, count = line.split("\t")
            pairs.append((int(taxid), int(count)))
    if pairs and data.endswith((b"\n", b" ", b"\t")):
        pairs.append(pairs[-1])
    return pairs
