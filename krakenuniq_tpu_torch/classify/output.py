"""Kraken output line formatting (host side).

Line format (classify.cpp:980-1010):
  C|U <tab> read_id <tab> taxid <tab> seq_len <tab> hitlist [<tab> seq]
hitlist is an RLE "taxon:count" list with 'A' for ambiguous k-mers
(classify.cpp:826-861); quick mode prints "Q:<hits>"; reads shorter than k
print "0:0".
"""

from __future__ import annotations

import numpy as np


def hitlist_string(taxa: np.ndarray, ambig: np.ndarray) -> str:
    """RLE over per-k-mer codes; ambiguous positions collapse to 'A'."""
    n = len(taxa)
    if n == 0:
        return "0:0"
    codes = np.where(ambig[:n], np.int64(-1), taxa[:n].astype(np.int64))
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    run_lens = np.diff(np.append(starts, n))
    parts = [
        f"A:{l}" if codes[s] < 0 else f"{codes[s]}:{l}"
        for s, l in zip(starts.tolist(), run_lens.tolist())
    ]
    return " ".join(parts)


def kraken_line(
    read_id: str,
    call: int,
    seq_len: int,
    taxa: np.ndarray,
    ambig: np.ndarray,
    quick: bool = False,
    hits: int = 0,
    sequence: str | None = None,
) -> str:
    status = "C" if call else "U"
    if quick:
        hl = f"Q:{hits}"
    else:
        hl = hitlist_string(taxa, ambig)
    line = f"{status}\t{read_id}\t{call}\t{seq_len}\t{hl}"
    if sequence is not None:
        line += f"\t{sequence}"
    return line + "\n"
