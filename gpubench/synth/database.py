"""The benchmark's reference database, made from a configuration's
`database` section and its `db_seed`.

It stands for a library built by `krakenuniq-build`: every species genome
of a genus descends from one ancestor genome and differs from it by
`divergence` substitutions; a k-mer found in several genomes is stored at
the lowest common ancestor of their species, as a build stores it, so the
tree resolution meets internal nodes. The rest of the library is `ballast`:
random canonical k-mers stored at a species or a genus, up to `keys` keys
in all. The taxonomy has NCBI's ranks from superkingdom to species and is
filled to `taxonomy_nodes` lines with genera of species that hold no
k-mers.

The genomes come from NumPy; the ballast, the minimizer bins and the sort by
(bin, key) run in torch on the given device, in a few large calls. A run
writes the directory once (`ensure`), and later runs of any configuration
that names the same database reuse it.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from ..reference.kmers import INDEX2_XOR_MASK, canonical, pack_windows
from ..reference.taxonomy import Closure, Tree
from .formats import write_index, write_kdb, write_taxdb

SPECIES_BASE = 10_000_000  # the species take the largest taxids
PAD_BASE = 1_000_000
PAD_SPECIES = 20  # species a genus of the taxa with no genome
# superkingdom of phylum p: p % 4 in (0, 1) Bacteria, 2 Archaea, 3 Viruses
_KINGDOMS = (2, 2, 2157, 10239)
_LEVELS = (("phylum", 200_000), ("class", 300_000), ("order", 400_000), ("family", 500_000),
           ("genus", 600_000))


def taxonomy(db: dict):
    """(taxids, parents, names, ranks, species taxids, genus taxids)."""
    n_species = db["species"]
    n_genera = -(-n_species // db["species_per_genus"])
    taxids = [1, 131567, 2, 2157, 10239]
    parents = [1, 1, 131567, 131567, 1]
    names = ["root", "cellular organisms", "Bacteria", "Archaea", "Viruses"]
    ranks = ["no rank", "no rank", "superkingdom", "superkingdom", "superkingdom"]
    # each level halves the one below it: two genera a family, two families
    # an order, and so on up to the phyla
    counts = [n_genera]
    for _ in range(len(_LEVELS) - 1):
        counts.append(-(-counts[-1] // 2))
    counts = counts[::-1]  # phylum first
    for level, ((rank, base), n) in enumerate(zip(_LEVELS, counts)):
        for i in range(n):
            taxids.append(base + i)
            parents.append(_KINGDOMS[i % 4] if level == 0 else _LEVELS[level - 1][1] + i // 2)
            names.append(f"{rank.capitalize()} {i}")
            ranks.append(rank)
    genus_base, family_base, n_families = _LEVELS[-1][1], _LEVELS[-2][1], counts[-2]
    species = [SPECIES_BASE + s for s in range(n_species)]
    for s, t in enumerate(species):
        taxids.append(t)
        parents.append(genus_base + s // db["species_per_genus"])
        names.append(f"Species {s}")
        ranks.append("species")
    # the taxa with no genome: genera of PAD_SPECIES leaf species each under
    # the families, as NCBI's unsequenced species sit in their genera
    n_pad = db["taxonomy_nodes"] - len(taxids)
    n_pad_genera = -(-n_pad // (PAD_SPECIES + 1))
    if n_pad < 0 or PAD_BASE + n_pad > SPECIES_BASE:
        raise ValueError(f"taxonomy_nodes {db['taxonomy_nodes']} cannot hold the tree ({len(taxids)} nodes)")
    taxids += range(PAD_BASE, PAD_BASE + n_pad)
    for i in range(n_pad):
        if i < n_pad_genera:
            parents.append(family_base + i % n_families)
            names.append(f"Unsequenced genus {i}")
            ranks.append("genus")
        else:
            parents.append(PAD_BASE + (i - n_pad_genera) % n_pad_genera)
            names.append(f"Unsequenced species {i}")
            ranks.append("species")
    genera = [genus_base + g for g in range(n_genera)]
    return taxids, parents, names, ranks, species, genera


def genomes(db: dict) -> np.ndarray:
    """uint8 [species, genome_len] codes 0-3."""
    rng = np.random.default_rng(db["db_seed"])
    n, length, spg = db["species"], db["genome_len"], db["species_per_genus"]
    ancestors = rng.integers(0, 4, size=(-(-n // spg), length), dtype=np.uint8)
    base = ancestors[np.arange(n) // spg]
    mutated = rng.random((n, length)) < db["divergence"]
    shift = rng.integers(1, 4, size=(n, length), dtype=np.uint8)
    return np.where(mutated, (base + shift) % 4, base).astype(np.uint8)


def genome_pairs(codes: np.ndarray, k: int, tree: Tree, species: list) -> tuple[np.ndarray, np.ndarray]:
    """The genomes' distinct canonical k-mers, sorted, each with the LCA of
    the species whose genomes hold it."""
    kmers = canonical(pack_windows(codes, k), k)
    sp = np.broadcast_to(np.arange(len(codes))[:, None], kmers.shape).reshape(-1)
    kmers = kmers.reshape(-1)
    order = np.argsort(kmers, kind="stable")
    kmers, sp = kmers[order], sp[order]
    clo = Closure(tree, np.asarray(species))
    rows = clo.index(np.asarray(species)[sp])
    first = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    group = np.cumsum(first) - 1
    lca = rows[first].copy()
    rank = np.arange(len(kmers)) - np.flatnonzero(first)[group]
    for r in range(1, int(rank.max()) + 1):
        sel = rank == r
        lca[group[sel]] = clo.lca[lca[group[sel]], rows[sel]]
    return kmers[first], clo.taxids[lca].astype(np.uint32)


_M = (0x3333333333333333, 0x0F0F0F0F0F0F0F0F, 0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF, 0xFFFFFFFF)


def _revcomp_t(x: torch.Tensor, n: int) -> torch.Tensor:
    """reference.kmers.reverse_complement on int64 tensors (values < 2^62);
    a right shift is masked to act as a logical one."""
    for i, s in enumerate((2, 4, 8, 16, 32)):
        x = ((x >> s) & _M[i]) | ((x & _M[i]) << s if s < 32 else x << s)
    return ((~x) >> (64 - 2 * n)) & ((1 << (2 * n)) - 1)


def canonical_t(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.minimum(x, _revcomp_t(x, n))


def bin_key_t(x: torch.Tensor, k: int, nt: int) -> torch.Tensor:
    """reference.kmers.bin_key on int64 tensors."""
    mask = (1 << (2 * nt)) - 1
    xm = INDEX2_XOR_MASK & mask
    best = torch.full_like(x, mask + 1)
    for i in range(k - nt + 1):
        best = torch.minimum(best, canonical_t((x >> (2 * i)) & mask, nt) ^ xm)
    return best


def build(db: dict, out_dir: str, device: str) -> dict:
    """Write the database directory: database.kdb, database.idx, taxDB and
    genomes.npy (the species' genomes, which the reads are drawn from)."""
    t0 = time.perf_counter()
    k, nt = db["k"], db["minimizer_len"]
    taxids, parents, names, ranks, species, genera = taxonomy(db)
    tree = Tree(np.asarray(taxids), np.asarray(parents))
    codes = genomes(db)
    g_keys, g_vals = genome_pairs(codes, k, tree, species)
    n_ballast = db["keys"] - len(g_keys)
    if n_ballast < 0:
        raise ValueError(f"keys {db['keys']} is below the genomes' {len(g_keys)} k-mers")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(db["db_seed"])
    draw = n_ballast + n_ballast // 64 + 1024
    x = canonical_t(torch.randint(0, 1 << (2 * k), (draw,), generator=gen, device=dev), k)
    # the first draw of each distinct key that is no genome key, in draw order
    xs, perm = torch.sort(x)
    first = torch.ones_like(xs, dtype=torch.bool)
    first[1:] = xs[1:] != xs[:-1]
    keep = perm[first]
    gk = torch.from_numpy(g_keys.view(np.int64)).to(dev)
    keep = torch.sort(keep[~torch.isin(x[keep], gk)]).values
    if len(keep) < n_ballast:
        raise RuntimeError("the ballast draw came out short")
    owners = torch.tensor(species + genera, dtype=torch.int64, device=dev)
    b_vals = owners[torch.randint(0, len(owners), (n_ballast,), generator=gen, device=dev)]
    keys = torch.cat([gk, x[keep[:n_ballast]]])
    del x, xs, perm, first, keep
    vals = torch.cat([torch.from_numpy(g_vals.astype(np.int64)).to(dev), b_vals])
    bins = bin_key_t(keys, k, nt)
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(bins[order], stable=True).indices]
    keys, vals, bins = keys[order], vals[order], bins[order]
    offsets = torch.zeros((1 << (2 * nt)) + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(bins, minlength=1 << (2 * nt)), 0)
    keys_h = keys.cpu().numpy().view(np.uint64)
    vals_h = vals.to(torch.int32).cpu().numpy().view(np.uint32)
    offsets_h = offsets.cpu().numpy().astype(np.uint64)
    del keys, vals, bins, order, offsets, gk, b_vals, owners
    t1 = time.perf_counter()
    tmp = out_dir + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_kdb(os.path.join(tmp, "database.kdb"), keys_h, vals_h, k)
    write_index(os.path.join(tmp, "database.idx"), nt, offsets_h)
    write_taxdb(os.path.join(tmp, "taxDB"), taxids, parents, names, ranks)
    np.save(os.path.join(tmp, "genomes.npy"), codes)
    info = {"genome_keys": int(len(g_keys)), "ballast_keys": int(n_ballast), "keys": int(len(keys_h)),
            "taxonomy_nodes": len(taxids), "make_s": t1 - t0, "write_s": time.perf_counter() - t1}
    with open(os.path.join(tmp, "synth.json"), "w") as f:
        json.dump(info, f)
    os.replace(tmp, out_dir)
    return info


def ensure(db: dict, data_dir: str, device: str) -> tuple[str, dict | None]:
    """The database's directory under data_dir, built if it is not there
    yet; returns it and, when this call built it, the build's numbers."""
    out = os.path.join(data_dir, db["name"])
    if os.path.exists(os.path.join(out, "synth.json")):
        return out, None
    os.makedirs(data_dir, exist_ok=True)
    return out, build(db, out, device)
