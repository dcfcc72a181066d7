"""Minimizer-range database partitioning.

The port's copy of krakenuniq_tpu/parallel/partition.py's numpy
partitioner. The reference's out-of-core chunking (`--preload-size`,
krakendb.cpp:463-522) binary-searches the largest minimizer range that fits
a memory budget; db/chunked.py cuts the minimizer space into N ranges of
(near-)equal key count instead. Each k-mer's minimizer lives in exactly one
range, the invariant the reference's chunk merge asserts (classify.cpp:447).
"""

from __future__ import annotations

import numpy as np


def partition_bins_equal_keys(offsets: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Cut bins [0, n_bins) into n_shards contiguous ranges with ~equal keys.

    offsets: (n_bins + 1) cumulative key counts. Returns [(bin_lo, bin_hi)).
    """
    offsets = np.asarray(offsets, dtype=np.uint64)
    n_bins = len(offsets) - 1
    total = int(offsets[-1])
    targets = [(total * i) // n_shards for i in range(1, n_shards)]
    cuts = [0]
    for t in targets:
        cut = int(np.searchsorted(offsets, t, side="left"))
        cut = max(cuts[-1], min(cut, n_bins))
        cuts.append(cut)
    cuts.append(n_bins)
    return [(cuts[i], cuts[i + 1]) for i in range(n_shards)]
