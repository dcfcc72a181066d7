"""Simulated-read generator for the accuracy harness.

The reference's accuracy loop (tests/test-on-simulated-reads.sh:30-53)
generates reads with BBMap `randomreads.sh` (fixed seed, 100 bp), classifies
them, and scores with `grade_classification`, which recovers the source
sequence id from the read name by skipping SIX underscores (the comment at
grade_classification.cpp:101 says "5th" but the do/while executes six
finds). BBMap is an external Java tool; this module reproduces the loop's
input contract offline: uniform position draws over the library sequences,
optional reverse-complement strand, optional substitution errors, and names
of the form

    READ_{i}_{start}_{end}_{strand}_{n_errors}_{seqid}

whose 6th-underscore suffix is exactly `seqid` (seqids may themselves
contain underscores -- the suffix parse keeps them intact).
"""

from __future__ import annotations

import numpy as np

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def simulate_reads(
    sequences: dict[str, str],
    n_reads: int,
    read_len: int = 100,
    error_rate: float = 0.0,
    seed: int = 1,
    both_strands: bool = True,
):
    """Yields (name, read) pairs drawn uniformly over `sequences`.

    Sequences shorter than read_len are skipped (randomreads.sh draws only
    full-length windows). Substitution errors replace the true base with one
    of the three others, uniformly -- BBMap's default error profile is
    quality-dependent; a flat rate is enough to exercise mismatch tolerance.
    """
    rng = np.random.default_rng(seed)
    ids = [s for s, seq in sequences.items() if len(seq) >= read_len]
    if not ids:
        raise ValueError(f"no sequence is >= {read_len} bp")
    picks = rng.integers(0, len(ids), size=n_reads)
    out = []
    for i in range(n_reads):
        sid = ids[int(picks[i])]
        seq = sequences[sid]
        start = int(rng.integers(0, len(seq) - read_len + 1))
        read = seq[start : start + read_len]
        strand = "F"
        if both_strands and rng.integers(0, 2):
            read, strand = revcomp(read), "R"
        n_err = 0
        if error_rate > 0.0:
            n_err = int(rng.binomial(read_len, error_rate))
            if n_err:
                pos = rng.choice(read_len, size=n_err, replace=False)
                b = list(read)
                for p in pos:
                    cur = b[p].upper()
                    choices = [c for c in "ACGT" if c != cur]
                    b[p] = choices[int(rng.integers(0, 3))]
                read = "".join(b)
        out.append(
            (f"READ_{i}_{start}_{start + read_len}_{strand}_{n_err}_{sid}", read)
        )
    return out


def write_simulated_fasta(
    path: str,
    sequences: dict[str, str],
    n_reads: int,
    read_len: int = 100,
    error_rate: float = 0.0,
    seed: int = 1,
) -> int:
    reads = simulate_reads(sequences, n_reads, read_len, error_rate, seed)
    with open(path, "w") as f:
        for name, read in reads:
            f.write(f">{name}\n{read}\n")
    return len(reads)
