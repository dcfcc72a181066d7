"""End-to-end simulated-read accuracy harness.

Mirrors the reference's tests/test-on-simulated-reads.sh:30-53 loop without
its external dependencies (BBMap, built DBs on NFS): simulate reads from the
database's own library with the truth taxid encoded in the read name
(grade_classification.cpp:101-108 convention), classify them against the
database, then grade per rank with report.grade.

Returns the grade stats dict plus the derived headline numbers
(read-level sensitivity/precision at the ranks of interest).
"""

from __future__ import annotations

import os

from ..formats.seqio import read_sequences
from ..utils.simulate import write_simulated_fasta
from .grade import RANKS_OF_INTEREST, grade


def simulate_and_grade(
    db_dir: str,
    work_dir: str,
    library_fastas: list[str] | None = None,
    n_reads: int = 1000,
    read_len: int = 100,
    error_rate: float = 0.0,
    seed: int = 1,
    classify_options=None,
):
    """Run the full loop in `work_dir`; returns (stats, files) where files
    maps {"reads", "kraken", "per_read", "stats"} to the paths written.
    The reads run through the port's Classifier on the card unless
    `classify_options` asks for the CPU (ClassifyOptions(device="cpu"))."""
    from ..classify import Classifier, ClassifyOptions

    if library_fastas is None:
        lib = os.path.join(db_dir, "library")
        library_fastas = []
        for root, _, names in os.walk(lib):
            library_fastas += [
                os.path.join(root, n)
                for n in sorted(names)
                if n.endswith((".fna", ".fa", ".fasta"))
            ]
        if not library_fastas:
            raise ValueError(f"no library FASTA under {lib}; pass library_fastas")

    sequences: dict[str, str] = {}
    for path in library_fastas:
        for dna in read_sequences(path):
            sequences[dna.id] = dna.seq

    os.makedirs(work_dir, exist_ok=True)
    reads_fa = os.path.join(work_dir, "simulated.fa")
    write_simulated_fasta(
        reads_fa, sequences, n_reads, read_len=read_len,
        error_rate=error_rate, seed=seed,
    )

    opts = classify_options or ClassifyOptions(print_progress=False)
    c = Classifier([db_dir], opts)
    kraken_path = os.path.join(work_dir, "simulated.kraken.tsv")
    with open(kraken_path, "w") as kf:
        c.run([reads_fa], kraken_fh=kf)

    per_read_path = os.path.join(work_dir, "simulated.grade.tsv")
    stats_path = os.path.join(work_dir, "simulated.stats.tsv")
    with open(per_read_path, "w") as pr, open(stats_path, "w") as st:
        stats = grade(
            os.path.join(db_dir, "taxDB"),
            os.path.join(db_dir, "seqid2taxid.map"),
            kraken_path,
            pr,
            st,
        )

    total = max(1, stats["total_reads"])
    stats["sensitivity"] = {
        r: 100.0 * stats["correct"][r] / total for r in RANKS_OF_INTEREST
    }
    stats["precision"] = {
        r: (
            100.0 * stats["correct"][r] / (stats["correct"][r] + stats["incorrect"][r])
            if stats["correct"][r] + stats["incorrect"][r]
            else float("nan")
        )
        for r in RANKS_OF_INTEREST
    }
    files = {
        "reads": reads_fa,
        "kraken": kraken_path,
        "per_read": per_read_path,
        "stats": stats_path,
    }
    return stats, files
