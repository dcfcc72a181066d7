"""Taxonomy tree: taxDB file I/O, NCBI dump parsing, and the dense/Euler
array encoding used by the device classifier.

File format (reference taxdb.hpp:563-605, MANUAL.md:74-77): text lines
  taxID <tab> parentID <tab> name <tab> rank [<tab> genomeSize <tab> genomeSizeOfChildren]
A synthetic entry 0 ("unclassified", rank "no rank") always exists
(taxdb.hpp:599). The root is taxid 1 (its own parent).

Device encoding: taxids are remapped to dense int32 indices (sorted taxid
order, so dense 0 == taxid 0 when present). Ancestor queries use Euler-tour
intervals: `u` is an ancestor-or-self of `t`  iff  tin[u] <= tin[t] < tout[u].
Nodes unreachable from the root get intervals in their own component so
in-component queries still work (mirroring the reference's behavior of
walking parent chains wherever they lead, krakenutil.cpp:149-200).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Taxonomy:
    taxids: np.ndarray  # uint32 [T], sorted ascending; dense id = position
    parent: np.ndarray  # int32 [T], dense parent index (self for roots/orphans)
    names: list[str]
    ranks: list[str]
    genome_size: np.ndarray  # uint64 [T] (k-mers in DB mapped directly to taxon)
    genome_size_children: np.ndarray  # uint64 [T]
    has_genome_sizes: bool
    # children in file order (list of np arrays of dense ids)
    children: list[np.ndarray]
    tin: np.ndarray  # int32 [T]
    tout: np.ndarray  # int32 [T]
    depth: np.ndarray  # int32 [T]; 0 for the root of each component

    @property
    def size(self) -> int:
        return len(self.taxids)

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.size else 0

    # ------------------------------------------------------------------ I/O

    @classmethod
    def from_taxdb_file(cls, path: str | os.PathLike) -> "Taxonomy":
        taxids: list[int] = []
        parents: list[int] = []
        names: list[str] = []
        ranks: list[str] = []
        gsize: list[int] = []
        gsize_c: list[int] = []
        has_sizes = False
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                if len(fields) < 4:
                    raise ValueError(f"{path}: bad taxDB line: {line!r}")
                taxids.append(int(fields[0]))
                parents.append(int(fields[1]))
                names.append(fields[2])
                ranks.append(fields[3])
                if len(fields) >= 6:
                    has_sizes = True
                    gsize.append(int(fields[4]))
                    gsize_c.append(int(fields[5]))
                else:
                    gsize.append(0)
                    gsize_c.append(0)
        return cls._build(taxids, parents, names, ranks, gsize, gsize_c, has_sizes)

    @classmethod
    def from_ncbi_dumps(
        cls, names_dmp: str | os.PathLike, nodes_dmp: str | os.PathLike
    ) -> "Taxonomy":
        """Parse NCBI taxonomy nodes.dmp/names.dmp (taxdb.hpp:460-519)."""
        taxids: list[int] = []
        parents: list[int] = []
        ranks: list[int] = []
        name_map: dict[int, str] = {}
        with open(nodes_dmp) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 3:
                    continue
                taxids.append(int(parts[0]))
                parents.append(int(parts[1]))
                ranks.append(parts[2])
        with open(names_dmp) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 4:
                    continue
                if parts[3] == "scientific name":
                    name_map[int(parts[0])] = parts[1]
        names = [name_map.get(t, "") for t in taxids]
        zeros = [0] * len(taxids)
        return cls._build(taxids, parents, names, ranks, zeros, list(zeros), False)

    def write_taxdb(self, path_or_fh, with_genome_sizes: bool | None = None) -> None:
        """Write the 4/6-column taxDB file sorted by taxID (taxdb.hpp:533-547).

        The synthetic taxid-0 entry is not written (the reference only adds
        it on read)."""
        ws = self.has_genome_sizes if with_genome_sizes is None else with_genome_sizes
        close = False
        if isinstance(path_or_fh, (str, os.PathLike)):
            fh = open(path_or_fh, "w")
            close = True
        else:
            fh = path_or_fh
        try:
            for i in np.argsort(self.taxids, kind="stable"):
                t = int(self.taxids[i])
                if t == 0:
                    continue
                p = int(self.taxids[self.parent[i]])
                fh.write(f"{t}\t{p}\t{self.names[i]}\t{self.ranks[i]}")
                if ws:
                    fh.write(f"\t{int(self.genome_size[i])}\t{int(self.genome_size_children[i])}")
                fh.write("\n")
        finally:
            if close:
                fh.close()

    # ------------------------------------------------------------ building

    @classmethod
    def _build(cls, taxids, parents, names, ranks, gsize, gsize_c, has_sizes) -> "Taxonomy":
        # inject the synthetic unclassified entry (taxdb.hpp:599)
        if 0 not in taxids:
            taxids = [0] + list(taxids)
            parents = [0] + list(parents)
            names = ["unclassified"] + list(names)
            ranks = ["no rank"] + list(ranks)
            gsize = [0] + list(gsize)
            gsize_c = [0] + list(gsize_c)

        tax_arr = np.asarray(taxids, dtype=np.uint32)
        order = np.argsort(tax_arr, kind="stable")
        # de-dup (the reference's insert() keeps the first occurrence)
        sorted_tax = tax_arr[order]
        keep_sorted = np.ones(len(order), dtype=bool)
        keep_sorted[1:] = sorted_tax[1:] != sorted_tax[:-1]
        order = order[keep_sorted]
        tax_sorted = tax_arr[order]

        t = len(order)
        names_s = [names[i] for i in order]
        ranks_s = [ranks[i] for i in order]
        gsize_s = np.asarray([gsize[i] for i in order], dtype=np.uint64)
        gsize_cs = np.asarray([gsize_c[i] for i in order], dtype=np.uint64)
        parent_tax = np.asarray([parents[i] for i in order], dtype=np.uint32)

        # dense parent: self-parent for roots, unknown parents, and taxid 0
        pos = np.searchsorted(tax_sorted, parent_tax)
        pos = np.clip(pos, 0, t - 1)
        found = tax_sorted[pos] == parent_tax
        self_idx = np.arange(t, dtype=np.int32)
        parent_dense = np.where(found, pos, self_idx).astype(np.int32)
        parent_dense = np.where(parent_tax == tax_sorted, self_idx, parent_dense)

        # children lists in file order (original input order among each parent)
        children_lists: list[list[int]] = [[] for _ in range(t)]
        file_rank = np.empty(t, dtype=np.int64)
        file_rank[:] = order  # original file position of each dense node
        by_file = np.argsort(file_rank, kind="stable")
        for d in by_file:
            p = parent_dense[d]
            if p != d:
                children_lists[p].append(int(d))
        children = [np.asarray(c, dtype=np.int32) for c in children_lists]

        tin, tout, depth = cls._euler(parent_dense, children, t)
        return cls(
            taxids=tax_sorted,
            parent=parent_dense,
            names=names_s,
            ranks=ranks_s,
            genome_size=gsize_s,
            genome_size_children=gsize_cs,
            has_genome_sizes=has_sizes,
            children=children,
            tin=tin,
            tout=tout,
            depth=depth,
        )

    @staticmethod
    def _euler(parent: np.ndarray, children: list[np.ndarray], t: int):
        tin = np.full(t, -1, dtype=np.int32)
        tout = np.full(t, -1, dtype=np.int32)
        depth = np.zeros(t, dtype=np.int32)
        clock = 0
        roots = [i for i in range(t) if parent[i] == i]
        for root in roots:
            stack = [(root, False)]
            while stack:
                node, done = stack.pop()
                if done:
                    tout[node] = clock
                    continue
                tin[node] = clock
                clock += 1
                stack.append((node, True))
                for c in reversed(children[node]):
                    depth[c] = depth[node] + 1
                    stack.append((int(c), False))
        return tin, tout, depth

    # ------------------------------------------------------------- queries

    def dense_index(self, taxid_arr: np.ndarray) -> np.ndarray:
        """Map taxids -> dense indices; unknown taxids map to dense(0)."""
        taxid_arr = np.asarray(taxid_arr, dtype=np.uint32)
        pos = np.searchsorted(self.taxids, taxid_arr)
        pos = np.clip(pos, 0, self.size - 1)
        found = self.taxids[pos] == taxid_arr
        return np.where(found, pos, 0).astype(np.int32)

    def parent_map(self) -> dict[int, int]:
        """taxid -> parent taxid map; roots map to 0 (taxdb.hpp:384-398)."""
        out: dict[int, int] = {}
        for i in range(self.size):
            t = int(self.taxids[i])
            if t == 0:
                continue
            p = self.parent[i]
            out[t] = 0 if p == i else int(self.taxids[p])
        return out

    def name_of(self, taxid: int) -> str:
        i = int(self.dense_index(np.asarray([taxid]))[0])
        if self.taxids[i] != taxid:
            return ""
        return self.names[i]

    def rank_of(self, taxid: int) -> str:
        i = int(self.dense_index(np.asarray([taxid]))[0])
        if self.taxids[i] != taxid:
            return ""
        return self.ranks[i]

    def is_ancestor_dense(self, a: int, b: int) -> bool:
        """Is dense node a an ancestor-or-self of dense node b?"""
        return bool(self.tin[a] <= self.tin[b] < self.tout[a])

    def taxid_at_rank(self, taxid: int, rank: str) -> int:
        """Walk up until a node with the given rank (taxdb.hpp:827-847)."""
        if taxid in (0, 1):
            return 0
        i = int(self.dense_index(np.asarray([taxid]))[0])
        if int(self.taxids[i]) != taxid:
            return 0
        while True:
            if self.ranks[i] == rank:
                return int(self.taxids[i])
            p = int(self.parent[i])
            if p == i:
                return 0
            i = p

    def set_genome_sizes(self, counts) -> None:
        """Accumulate per-taxon k-mer counts up the tree (taxdb.hpp:850-885).

        Accepts a dict or an iterable of (taxid, size) pairs; duplicated
        pairs accumulate (the reference's counts-file reader emits the last
        line twice -- see formats.counts.read_counts_stream_bugcompat)."""
        items = counts.items() if hasattr(counts, "items") else counts
        for taxid, size in items:
            i = int(self.dense_index(np.asarray([taxid], dtype=np.uint32))[0])
            if int(self.taxids[i]) != int(taxid):
                continue  # reference warns "No taxonomy entry for X"
            self.genome_size[i] += np.uint64(size)
            while True:
                p = int(self.parent[i])
                if p == i:
                    break
                i = p
                self.genome_size_children[i] += np.uint64(size)
        self.has_genome_sizes = True

    def with_added_nodes(self, nodes) -> "Taxonomy":
        """Return a new Taxonomy with (taxid, parent, name, rank) nodes
        appended (the reference's dynamic insert, taxdb.hpp:712-734)."""
        taxids = [int(t) for t in self.taxids]
        parents = [int(self.taxids[p]) for p in self.parent]
        names = list(self.names)
        ranks = list(self.ranks)
        gs = list(int(x) for x in self.genome_size)
        gsc = list(int(x) for x in self.genome_size_children)
        for taxid, parent, name, rank in nodes:
            taxids.append(int(taxid))
            parents.append(int(parent))
            names.append(name)
            ranks.append(rank)
            gs.append(0)
            gsc.append(0)
        return Taxonomy._build(taxids, parents, names, ranks, gs, gsc, self.has_genome_sizes)

    def lca_pairs(self, ta: np.ndarray, tb: np.ndarray) -> np.ndarray:
        """Vectorized lca_fold over taxid pairs: LCA(ta[i], tb[i]) for whole
        arrays, with the reference fold semantics (krakenutil.cpp:90-118):
        0 is the identity, unknown taxids resolve to 1, disconnected pairs
        resolve to 1.

        Distinct (a, b) pairs are deduplicated before the walk -- the
        vectorized form of the old dict LCA cache: the ancestor walk runs on
        the handful of distinct taxid pairs a library actually contains, not
        on every k-mer."""
        ta = np.asarray(ta, dtype=np.uint32)
        tb = np.asarray(tb, dtype=np.uint32)
        packed = (ta.astype(np.uint64) << np.uint64(32)) | tb.astype(np.uint64)
        up, inv = np.unique(packed, return_inverse=True)
        a = (up >> np.uint64(32)).astype(np.uint32)
        b = up.astype(np.uint32)

        da = self.dense_index(a)
        db = self.dense_index(b)
        known_a = (self.taxids[da] == a) & (a != 0)
        known_b = (self.taxids[db] == b) & (b != 0)

        tin_a = self.tin[da].astype(np.int64)
        tin_b = self.tin[db].astype(np.int64)
        tmin = np.where(known_b, np.minimum(tin_a, tin_b), tin_a)
        tmin = np.where(known_a, tmin, tin_b)
        tmax = np.where(known_b, np.maximum(tin_a, tin_b), tin_a)
        tmax = np.where(known_a, tmax, tin_b)
        node = np.where(known_a, da, db).astype(np.int64)
        node = np.where(tin_b < tin_a, np.where(known_b, db, node), node)

        active = known_a | known_b
        out = np.zeros(len(up), dtype=np.uint32)
        # identity / unknown-member rules first (matching lca_fold):
        #   both zero -> 0; one zero/unknown member with nonzero taxid -> 1;
        #   one known member alone -> that member
        one_sided = known_a ^ known_b
        other_nonzero = np.where(known_a, b, a) != 0
        out[one_sided & ~other_nonzero] = np.where(known_a, a, b)[
            one_sided & ~other_nonzero
        ]
        unknown_member = one_sided & other_nonzero
        out[unknown_member] = 1
        neither = ~known_a & ~known_b
        out[neither & ((a != 0) | (b != 0))] = 1
        walk = known_a & known_b
        # ancestor walk from the min-tin member until the node's Euler range
        # contains tmax (lca_fold's loop, vectorized over distinct pairs)
        for _ in range(self.max_depth + 2):
            if not walk.any():
                break
            contained = (self.tin[node] <= tmin) & (tmax < self.tout[node])
            done = walk & contained
            out[done] = self.taxids[node[done]]
            walk &= ~contained
            p = self.parent[node]
            stalled = walk & (p == node)
            out[stalled] = 1  # disconnected forest: resolve to root
            walk &= ~stalled
            node = np.where(walk, p, node)
        out[walk] = 1
        return out[inv]

    def lca_fold(self, taxids) -> int:
        """LCA of a set of taxids (fold semantics of krakenutil.cpp:90-118:
        unknown/disconnected members resolve toward the root)."""
        ids = [int(t) for t in taxids if int(t) != 0]
        if not ids:
            return 0
        dense = self.dense_index(np.asarray(ids, dtype=np.uint32))
        known = dense[(self.taxids[dense] == np.asarray(ids, dtype=np.uint32))]
        if len(known) == 0:
            return 1
        tins = self.tin[known]
        tmin, tmax = int(tins.min()), int(tins.max())
        node = int(known[0])
        while True:
            if self.tin[node] <= tmin and tmax < self.tout[node]:
                break
            p = int(self.parent[node])
            if p == node:
                return 1
            node = p
        if len(known) < len(ids):
            return 1  # some member had no tree entry -> reference lca gives 1
        return int(self.taxids[node])

    def lineage(self, taxid: int) -> str:
        """Semicolon lineage string (taxdb.hpp:764-780): skips 'cellular
        organisms' (131567), resets above species, ends with '.'."""
        out = ""
        i = int(self.dense_index(np.asarray([taxid], dtype=np.uint32))[0])
        if int(self.taxids[i]) != int(taxid):
            return ""
        while True:
            t = int(self.taxids[i])
            if t != 131567:
                if out:
                    out = "; " + out
                out = self.names[i] + out
                if self.ranks[i] == "species":
                    out = ""
            p = int(self.parent[i])
            if p == i:
                if out:
                    out += "."
                break
            i = p
        return out

    _MPA_RANKS = {
        "species": "s", "genus": "g", "family": "f", "order": "o",
        "class": "c", "phylum": "p", "superkingdom": "k",
    }

    def metaphlan_lineage(self, taxid: int) -> str:
        """MetaPhlAn-style lineage (taxdb.hpp:783-825)."""
        i = int(self.dense_index(np.asarray([taxid], dtype=np.uint32))[0])
        if int(self.taxids[i]) != int(taxid):
            return ""
        if self.ranks[i] == "superphylum":
            return ""
        parts: list[str] = []
        while True:
            code = self._MPA_RANKS.get(self.ranks[i], "-")
            parts.insert(0, f"|{code}__{self.names[i]}")
            p = int(self.parent[i])
            if p == i:
                break
            i = p
        return "".join(parts).replace(" ", "_")

    def resolve_tree_host(self, hit_counts: dict) -> int:
        """Host-side resolve_tree (krakenutil.cpp:149-200 semantics), used for
        reads too long for the on-device O(W^2) formulation."""
        if not hit_counts:
            return 0
        taxa = np.asarray(list(hit_counts.keys()), dtype=np.uint32)
        counts = np.asarray(list(hit_counts.values()), dtype=np.int64)
        dense = self.dense_index(taxa)
        found = self.taxids[dense] == taxa
        tins = self.tin[dense].astype(np.int64)
        touts = self.tout[dense].astype(np.int64)
        # unknown taxa get disjoint self-only intervals
        fake = -2 * np.arange(1, len(taxa) + 1, dtype=np.int64)
        tins = np.where(found, tins, fake)
        touts = np.where(found, touts, fake + 1)
        anc = (tins[:, None] <= tins[None, :]) & (tins[None, :] < touts[:, None])
        scores = (counts[:, None] * anc).sum(axis=0)
        mx = scores.max()
        tied = taxa[scores == mx]
        if len(tied) == 1:
            return int(tied[0])
        return self.lca_fold(tied.tolist())
