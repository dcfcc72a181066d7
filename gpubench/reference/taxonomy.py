"""The taxonomy as the reference needs it: each taxon's parent, read from the
taxDB file (taxid, parent, name, rank per line), and lowest common
ancestors over the few taxa that a database's values reach."""

from __future__ import annotations

import re

import numpy as np

_LINE = re.compile(rb"^(\d+)\t(\d+)\t", re.M)


class Tree:
    """Parents of every taxon of a taxDB; the root is its own parent."""

    def __init__(self, taxids: np.ndarray, parents: np.ndarray):
        order = np.argsort(taxids, kind="stable")
        self.taxids = np.asarray(taxids, np.int64)[order]
        self.parents = np.asarray(parents, np.int64)[order]

    @classmethod
    def from_taxdb(cls, path: str) -> "Tree":
        with open(path, "rb") as f:
            pairs = np.array(_LINE.findall(f.read()), dtype=np.int64)
        return cls(pairs[:, 0], pairs[:, 1])

    def parent(self, taxids: np.ndarray) -> np.ndarray:
        t = np.asarray(taxids, np.int64)
        i = np.clip(np.searchsorted(self.taxids, t), 0, len(self.taxids) - 1)
        if not np.array_equal(self.taxids[i], t):
            raise KeyError(f"taxa missing from the taxonomy: {t[self.taxids[i] != t][:5]}")
        return self.parents[i]

    def closure(self, taxids) -> np.ndarray:
        """The taxa and all their ancestors, sorted."""
        seen = set()
        todo = {int(t) for t in np.asarray(taxids).reshape(-1)}
        while todo:
            seen |= todo
            up = {int(p) for p in self.parent(np.fromiter(todo, np.int64))}
            todo = up - seen
        return np.array(sorted(seen), dtype=np.int64)

    def paths(self, nodes: np.ndarray) -> list[list[int]]:
        """Each node's root path, root first."""
        out = []
        for t in nodes.tolist():
            path = [t]
            while True:
                p = int(self.parent(np.array([path[-1]]))[0])
                if p == path[-1]:
                    break
                path.append(p)
            out.append(path[::-1])
        return out


class Closure:
    """Index over a closed set of taxa (every ancestor of a member is one):
    `index` maps taxids to rows, `anc[i, j]` is whether row j is an ancestor
    of row i or i itself, `lca[i, j]` the row of their lowest common
    ancestor."""

    def __init__(self, tree: Tree, taxids):
        self.taxids = tree.closure(taxids)
        paths = tree.paths(self.taxids)
        row = {t: i for i, t in enumerate(self.taxids.tolist())}
        n = len(self.taxids)
        depth = max(len(p) for p in paths)
        chain = np.full((n, depth), -1, dtype=np.int64)
        for i, p in enumerate(paths):
            chain[i, : len(p)] = [row[t] for t in p]
        self.chain = chain  # each row's root path, root first, -1 past its end
        self.anc = np.zeros((n, n), dtype=bool)
        for d in range(depth):
            ok = chain[:, d] >= 0
            self.anc[np.flatnonzero(ok), chain[ok, d]] = True
        # the deepest shared entry of the two root paths
        same = (chain[:, None, :] == chain[None, :, :]) & (chain[:, None, :] >= 0)
        last = depth - 1 - np.argmax(same[:, :, ::-1], axis=2)
        self.lca = np.take_along_axis(chain[:, None, :].repeat(n, axis=1), last[:, :, None], axis=2)[:, :, 0]

    def index(self, taxids: np.ndarray) -> np.ndarray:
        t = np.asarray(taxids, np.int64)
        i = np.clip(np.searchsorted(self.taxids, t), 0, len(self.taxids) - 1)
        if not np.array_equal(self.taxids[i], t):
            raise KeyError("taxa outside the closure")
        return i
