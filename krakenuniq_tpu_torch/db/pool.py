"""Value pool: the database's LCA-closed value dictionary.

The classify step's symbol space does not need to be the whole taxonomy --
counted k-mers only ever carry DATABASE VALUES (the LCA taxids stored in the
pair array, classify.cpp:939), and resolve_tree's answers are LCAs of hit
subsets (krakenutil.cpp:149-200), i.e. members of the value set's LCA
closure. That closure has at most 2*|values| - 1 nodes (the classic
virtual/auxiliary-tree bound: closing a tin-sorted set under CONSECUTIVE
pairwise LCAs closes it under all subset LCAs), so for any real database it
is tiny next to the ~2.4M-node NCBI taxonomy (taxdb.hpp:460-488).

When the closure fits 16 bits, every hot-path table is re-indexed by POOL id
instead of dense taxonomy id:

  * hash-table value words store pool ids (narrower value field, smaller
    tables for big taxonomies: the CHD width floor is bit_length(P), not
    bit_length(2.4M) -- chd_min_lr in db/hash_table.py);
  * the resolve tables (tin/tout/parent) shrink to [P] -- VMEM-resident
    gathers instead of a 2.4M-row HBM table -- and the tie-LCA chain walk
    runs on the VIRTUAL (closure) parent in <= closure-depth steps;
  * compact RLE rows and the 6B/lane HLL feed carry u16 pool ids at ANY
    taxonomy size with NO per-span dictionary (the pool is a global,
    load-time dictionary -- the per-span local_dict machinery in
    device_step.py remains only as the >65535-value fallback);
  * --device-counters counters are pool-width: bincounts of length P, not T.

Correctness of the virtual parent walk: for a tied candidate set S of pool
nodes, LCA(S) = LCA(argmin tin, argmax tin) is itself in the closure, and no
node strictly below it contains S's interval hull -- so walking the closure
parent chain from the argmax candidate finds exactly the node the reference's
full parent-chain walk finds (krakenutil.cpp:117-147).

The pool id space is ordered by dense id (ascending taxid), so pool id 0 is
dense 0 = taxid 0: a missed lookup's zero word means "unclassified" in both
spaces, and sentinel semantics carry over unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POOL_CAP = 0xFFFF  # ids must fit u16 with 0xFFFF free as the feed sentinel


@dataclasses.dataclass
class ValuePool:
    rows: np.ndarray  # int32 [P] sorted dense node ids; rows[0] == 0
    taxids: np.ndarray  # uint32 [P] original taxid per pool id
    tin: np.ndarray  # int32 [P] Euler entry time (node space values)
    tout: np.ndarray  # int32 [P] Euler exit time
    parent: np.ndarray  # int32 [P] closure parent pool id (self for roots)
    root: int  # pool id of the taxonomy root (taxid 1)
    max_depth: int  # max closure-chain depth (bounds the tie-LCA walk)

    @property
    def size(self) -> int:
        return len(self.rows)

    def pool_index(self, dense: np.ndarray) -> np.ndarray:
        """dense node ids -> pool ids (caller guarantees membership)."""
        return np.searchsorted(self.rows, dense).astype(np.int32)


def _pairwise_lca(a: np.ndarray, b: np.ndarray, tax) -> np.ndarray:
    """Vectorized LCA of dense-id pairs: lift `a` along real parents until
    its interval contains b (<= max_depth steps of numpy ops)."""
    a = a.astype(np.int64).copy()
    tin, tout, parent = tax.tin, tax.tout, tax.parent
    tb = tin[b]
    for _ in range(int(tax.max_depth) + 1):
        ok = (tin[a] <= tb) & (tb < tout[a])
        if ok.all():
            break
        a[~ok] = parent[a[~ok]]
    return a


def build_value_pool(vals_dense_list, tax, cap: int = POOL_CAP) -> ValuePool | None:
    """Build the LCA-closed pool over one or more databases' dense value
    arrays (hierarchical multi-DB lookups share ONE id space). Returns None
    when the closure exceeds `cap` (callers fall back to dense-id tables +
    the per-span local_dict)."""
    uniqs = [np.unique(np.asarray(v, dtype=np.int64)) for v in vals_dense_list]
    root_dense = int(np.searchsorted(tax.taxids, 1))
    have_root = root_dense < tax.size and tax.taxids[root_dense] == 1
    base = np.unique(np.concatenate(uniqs + [np.asarray([0, root_dense if have_root else 0], np.int64)]))
    if len(base) > cap:
        return None
    # closure under consecutive-pair LCAs in tin (preorder) order; node 0 is
    # its own component and never an LCA operand partner worth adding
    nz = base[base != 0]
    if len(nz) > 1:
        order = np.argsort(tax.tin[nz])
        s = nz[order]
        lcas = _pairwise_lca(s[:-1], s[1:], tax)
        pool = np.unique(np.concatenate([base, lcas]))
    else:
        pool = base
    if len(pool) > cap:
        return None

    rows = pool.astype(np.int32)
    tinp = tax.tin[rows].astype(np.int32)
    toutp = tax.tout[rows].astype(np.int32)

    # closure parent: nearest proper closure ancestor, found with a stack
    # pass over the pool in tin order (ancestors have smaller tin and
    # enclosing tout)
    order = np.argsort(tinp, kind="stable")
    parent_pool = np.arange(len(rows), dtype=np.int32)  # self = closure root
    depth = np.zeros(len(rows), dtype=np.int32)
    stack: list[int] = []
    for pid in order.tolist():
        while stack and not (
            tinp[stack[-1]] <= tinp[pid] and tinp[pid] < toutp[stack[-1]]
        ):
            stack.pop()
        if stack and stack[-1] != pid:
            parent_pool[pid] = stack[-1]
            depth[pid] = depth[stack[-1]] + 1
        stack.append(pid)

    root = int(np.searchsorted(rows, root_dense)) if have_root else 0
    return ValuePool(
        rows=rows,
        taxids=tax.taxids[rows].astype(np.uint32),
        tin=tinp,
        tout=toutp,
        parent=parent_pool,
        root=root,
        max_depth=int(depth.max()) if len(depth) else 0,
    )
