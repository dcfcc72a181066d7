"""Reads of a traffic mix, drawn from `--seed`: one general generator over
the parameters of `traffic/<name>.json`.

  read_len           bases a read
  reads_per_sample   reads in one sample, which the window classifies and
                     reports as a whole
  foreign_share      share of reads of random sequence, standing for
                     organisms (or host DNA) absent from the database; the
                     count is fixed, the seed places them
  log_mu, log_sigma  the species' abundances: log-normal, as CAMISIM draws
                     a community's; species i of n takes the distribution's
                     quantile at (i + 0.5) / n, and the database's reads are
                     shared out in proportion, rounded by largest remainder
  substitution_rate  share of bases replaced by another base
  n_rate             share of bases read as N
  warmup_reads       the first reads again, as the set-up's warm-up sample

Every seed gives the same number of reads, lengths, reads a species and
foreign reads; the seed draws positions, strands, errors, the foreign
sequence and the order of the reads.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

from ..reference.classify import Reads

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
_QUAL = ord("F")  # Illumina's binned Q37


def species_reads(traffic: dict, n_species: int, n_reads: int) -> np.ndarray:
    """Reads a species, the same for every seed: the log-normal's quantiles
    as weights, shared out by largest remainder (species 0 the most)."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n_species) for i in range(n_species)])[::-1]
    w = np.exp(traffic["log_mu"] + traffic["log_sigma"] * z)
    share = n_reads * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(counts - share, kind="stable")[: n_reads - int(counts.sum())]] += 1
    return counts


def make(traffic: dict, genomes: np.ndarray, seed: int) -> Reads:
    rng = np.random.default_rng(int(seed) & ((1 << 64) - 1))
    n, length = traffic["reads_per_sample"], traffic["read_len"]
    n_species, genome_len = genomes.shape
    if genome_len < length:
        raise ValueError("reads longer than the genomes")
    foreign = np.zeros(n, dtype=bool)
    foreign[rng.permutation(n)[: round(n * traffic["foreign_share"])]] = True
    n_g = int((~foreign).sum())
    sp = rng.permutation(np.repeat(np.arange(n_species), species_reads(traffic, n_species, n_g)))
    start = rng.integers(0, genome_len - length + 1, size=n_g)
    codes = np.empty((n, length), dtype=np.uint8)
    g = genomes[sp[:, None], start[:, None] + np.arange(length)[None, :]]
    minus = rng.random(n_g) < 0.5
    g[minus] = 3 - g[minus, ::-1]
    codes[~foreign] = g
    codes[foreign] = rng.integers(0, 4, size=(n - n_g, length), dtype=np.uint8)
    sub = rng.random((n, length)) < traffic["substitution_rate"]
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
    codes[rng.random((n, length)) < traffic["n_rate"]] = 4
    width = len(str(n - 1))
    ids = [f"r{i:0{width}d}" for i in range(n)]
    return Reads(ids=ids, codes=codes, lengths=np.full(n, length, dtype=np.int64))


def write_fastq(path: str, reads: Reads, first: int | None = None) -> None:
    """The reads (the first `first` of them) as FASTQ, one block write."""
    codes = reads.codes[:first]
    n, length = codes.shape
    idw = len(reads.ids[0])
    rec = np.empty((n, 1 + idw + 1 + length + 3 + length + 1), dtype=np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1:1 + idw] = np.frombuffer("".join(reads.ids[:n]).encode(), dtype=np.uint8).reshape(n, idw)
    o = 1 + idw
    rec[:, o] = ord("\n")
    rec[:, o + 1:o + 1 + length] = _BASES[codes]
    o += 1 + length
    rec[:, o:o + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, o + 3:o + 3 + length] = _QUAL
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())
