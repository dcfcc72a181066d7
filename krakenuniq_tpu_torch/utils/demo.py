"""Deterministic in-memory demo database + reads (no files, no downloads).

Used by __graft_entry__ and bench.py to exercise the full classify step at
arbitrary scale: synthetic genomes under a small taxonomy, the same
canonical-k-mer/minimizer layout as a real database.

The build runs entirely on HOST numpy: a k-iteration shift cascade packs all
windows at once, so a 4.8M-k-mer database takes seconds. (An earlier device
version was algorithmically fast but spent minutes in XLA compiles and
transfers on remote-transport environments -- the demo DB is bench warmup,
so host determinism and zero compile cost win.)
"""

from __future__ import annotations

import numpy as np

from ..taxonomy import Taxonomy
from ..utils import bits

_BASES_B = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_demo_taxonomy(
    n_species: int, species_base: int = 1000, pad_nodes: int = 0
) -> tuple[Taxonomy, list[int]]:
    """pad_nodes appends extra leaf species (taxids 1_000_000+i) that carry
    no genomes -- inflating the taxonomy to NCBI-like node counts (~2.4M,
    taxdb.hpp:460-488) without inflating the database. Pick species_base
    above 1_000_000 + pad_nodes to give the real species the LARGEST dense
    ids (exercises id-width edges)."""
    taxids = [1, 2]
    parents = [1, 1]
    names = ["root", "Bacteria"]
    ranks = ["no rank", "superkingdom"]
    species = []
    n_genera = max(1, n_species // 4)
    for g in range(n_genera):
        gid = 100 + g
        taxids.append(gid)
        parents.append(2)
        names.append(f"Genus{g}")
        ranks.append("genus")
    for p in range(pad_nodes):
        taxids.append(1_000_000 + p)
        parents.append(2)
        names.append(f"Pad {p}")
        ranks.append("species")
    for s in range(n_species):
        sid = species_base + s
        taxids.append(sid)
        parents.append(100 + (s % n_genera))
        names.append(f"Species {s}")
        ranks.append("species")
        species.append(sid)
    tax = Taxonomy._build(taxids, parents, names, ranks, [0] * len(taxids), [0] * len(taxids), False)
    return tax, species


def _host_pack_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mer windows of 2-bit codes, packed into uint64 (host numpy)."""
    s, l = codes.shape
    w = l - k + 1
    kmers = np.zeros((s, w), dtype=np.uint64)
    for i in range(k):
        kmers <<= np.uint64(2)
        kmers |= codes[:, i : i + w].astype(np.uint64)
    return kmers


def make_demo_db(
    n_species: int = 8,
    genome_len: int = 4000,
    k: int = 31,
    nt: int = 9,
    seed: int = 7,
    species_base: int = 1000,
    pad_nodes: int = 0,
    ballast_keys: int = 0,
):
    """Returns (keys, vals, offsets, taxonomy, genomes_by_taxid) with keys
    sorted in reference (minimizer-bin, key) order.

    ballast_keys appends that many random canonical k-mers (values drawn
    from the same species set) so benchmarks can reach 10^8-key scale
    without 10^8 bp of genome synthesis. Ballast bins are drawn uniformly
    instead of computed (bin_key over 10^8 keys costs minutes of host
    bandwidth, and a uniform draw is statistically indistinguishable from
    the XOR-scrambled minimizer of a uniform key): only the bsearch lookup
    path consults bins at query time, and it binary-searches whatever range
    the index declares -- the hash path (the benchmarked one) addresses by
    key hash alone."""
    tax, species = make_demo_taxonomy(n_species, species_base, pad_nodes)
    rng = np.random.default_rng(seed)
    host_codes = rng.integers(0, 4, size=(n_species, genome_len), dtype=np.uint8)

    kmers = bits.canonical_representation(
        _host_pack_windows(host_codes, k).reshape(-1), k
    )
    sp = np.broadcast_to(
        np.arange(n_species, dtype=np.uint32)[:, None],
        (n_species, genome_len - k + 1),
    ).reshape(-1)
    # sort by key with species order as tiebreak (first genome wins ties --
    # the same dedup the earlier stable device sort produced)
    order = np.lexsort((sp, kmers))
    skeys = kmers[order]
    ssp = sp[order]
    first = np.concatenate([[True], skeys[1:] != skeys[:-1]])
    keys = skeys[first]
    sp = ssp[first]

    b = bits.bin_key(keys, k, nt)
    if ballast_keys:
        extra = bits.canonical_representation(
            rng.integers(0, 1 << (2 * k), size=ballast_keys, dtype=np.uint64), k
        )
        # sort-then-dedup equals np.unique; numpy >= 2.3's hash-based
        # np.unique takes minutes on 10^8 distinct keys, the sort seconds
        extra.sort()
        extra = extra[np.concatenate([[True], extra[1:] != extra[:-1]])]
        gsorted = np.sort(keys)
        pos = np.searchsorted(gsorted, extra)
        pos = np.clip(pos, 0, len(gsorted) - 1)
        extra = extra[gsorted[pos] != extra]  # drop collisions with genome keys
        keys = np.concatenate([keys, extra])
        sp = np.concatenate(
            [sp, rng.integers(0, n_species, size=len(extra)).astype(np.uint32)]
        )
        b = np.concatenate(
            [b, rng.integers(0, 4**nt, size=len(extra), dtype=np.uint64)]
        )
        # two stable passes = lexsort((keys, b)) at 1e8 scale
        order = np.argsort(keys, kind="stable")
        keys, sp, b = keys[order], sp[order], b[order]
        order = np.argsort(b, kind="stable")
    else:
        order = np.lexsort((keys, b))
    keys = keys[order]
    sp = sp[order]
    counts = np.bincount(b.astype(np.int64), minlength=4**nt)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    vals = np.asarray(species, dtype=np.uint32)[sp]

    genomes = {}
    for i, sid in enumerate(species):
        genomes[sid] = _BASES_B[host_codes[i]].tobytes().decode()
    return keys, vals, offsets, tax, genomes


def make_demo_reads(
    genomes: dict[int, str], n_reads: int, read_len: int = 150, seed: int = 11
) -> list[str]:
    rng = np.random.default_rng(seed)
    sids = list(genomes)
    picks = rng.integers(0, len(sids), size=n_reads)
    out = []
    for i in range(n_reads):
        g = genomes[sids[int(picks[i])]]
        start = int(rng.integers(0, max(1, len(g) - read_len)))
        out.append(g[start : start + read_len])
    return out
