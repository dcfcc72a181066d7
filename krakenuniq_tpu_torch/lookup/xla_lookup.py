"""Two-level database lookup: the minimizer bin's offsets, then a binary
search over the bin's sorted k-mers.

Counterpart of krakenuniq_tpu/lookup/xla_lookup.py (the module keeps its
name). Semantics of the reference's kmer_query (krakendb.cpp:250-321): the
minimizer selects a bin through the offset table; a lower-bound search over
the sorted bin finds the k-mer; a miss returns taxon 0. Every lane runs the
same fixed trip count `n_iter` (DeviceDB.search_iters), then the compare.

This is the lookup of a database whose hash-table build failed
(db/device_db.build_device_db's fallback): the sorted planes answer every
query the table would. `lookup_kmers` launches the `bsearch_lookup` CUDA
kernel (csrc/bsearch_lookup.cu) on CUDA tensors and runs
`lookup_kmers_plain`, the JAX package's loop in plain PyTorch, on CPU
tensors. The keys are sorted only within each bin, so torch.searchsorted
over the whole plane does not compute the same function.
"""

from __future__ import annotations

import torch

from .. import _kernels


def _check_planes(name, keys, vals, vals_dense, offsets, query, bins, valid):
    if keys.dtype != torch.int64 or offsets.dtype != torch.int64 or query.dtype != torch.int64:
        raise TypeError(f"{name}: keys, offsets and query must be int64")
    if vals.dtype != torch.int32 or vals_dense.dtype != torch.int32:
        raise TypeError(f"{name}: vals and vals_dense must be int32")
    if bins.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: bins must be int64 and valid bool")
    if not (keys.shape == vals.shape == vals_dense.shape) or keys.dim() != 1 or offsets.dim() != 1:
        raise ValueError(f"{name}: keys, vals, vals_dense must be [N] and offsets [n_bins + 1]")
    if not (query.shape == bins.shape == valid.shape):
        raise ValueError(f"{name}: query, bins and valid must share one shape")
    if offsets.numel() < 1:
        raise ValueError(f"{name}: offsets must hold at least one entry")


def search_bins(keys, offsets, query, bins, valid, n_iter: int, bin_start: int = 0):
    """The masked lower-bound search of lookup_kmers_plain over flattened
    lanes: (pos int64 [n], the result position clamped into keys; found
    bool [n], the key there is the query of a valid lane in range)."""
    q = query.reshape(-1)
    b = bins.reshape(-1) - bin_start
    v = valid.reshape(-1)
    n = keys.shape[0]
    n_bins = offsets.shape[0] - 1
    in_range = (b >= 0) & (b < n_bins) & v
    b_safe = b.clamp(0, max(n_bins - 1, 0))
    zero = torch.zeros_like(q)
    lo = torch.where(in_range, offsets[b_safe], zero)
    hi = torch.where(in_range, offsets[(b_safe + 1).clamp(max=n_bins)], zero)
    hi0 = hi
    for _ in range(n_iter):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = keys[mid.clamp(0, n - 1)] < q
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    pos = lo.clamp(0, n - 1)
    return pos, (lo < hi0) & (keys[pos] == q) & in_range


def lookup_kmers_plain(keys, vals, vals_dense, offsets, query, bins, valid, n_iter: int,
                       bin_start: int = 0):
    """Plain version of `lookup_kmers`: the masked lower-bound search of
    krakenuniq_tpu/lookup/xla_lookup.py:lookup_kmers, its fori_loop as a
    torch loop of exactly n_iter steps."""
    _check_planes("lookup_kmers", keys, vals, vals_dense, offsets, query, bins, valid)
    shape = query.shape
    if keys.shape[0] == 0:
        zero = torch.zeros(shape, dtype=torch.int32, device=query.device)
        return zero, zero.clone()
    pos, found = search_bins(keys, offsets, query, bins, valid, n_iter, bin_start)
    taxon = torch.where(found, vals[pos], 0)
    taxon_dense = torch.where(found, vals_dense[pos], 0)
    return taxon.reshape(shape), taxon_dense.reshape(shape)


def lookup_kmers(keys, vals, vals_dense, offsets, query, bins, valid, n_iter: int,
                 bin_start: int = 0):
    """(taxon int32 [...] (the stored uint32 value's bits), taxon_dense int32
    [...]) per lane, 0 where missing or not valid. keys int64 [N] (canonical
    k-mers, sorted within each bin), vals and vals_dense int32 [N], offsets
    int64 [n_bins + 1] (relative to keys[0]); query (canonical k-mers) and
    bins (minimizer bin keys, `kmer_bins`) int64 and valid bool of one
    shape. A lane searches bin `bins - bin_start` for exactly n_iter steps.
    CUDA tensors launch the `bsearch_lookup` kernel."""
    if query.device.type == "cpu":
        return lookup_kmers_plain(keys, vals, vals_dense, offsets, query, bins, valid, n_iter, bin_start)
    _check_planes("bsearch_lookup", keys, vals, vals_dense, offsets, query, bins, valid)
    dev = _kernels.check_cuda("bsearch_lookup", keys=keys, vals=vals, vals_dense=vals_dense,
                              offsets=offsets, query=query, bins=bins, valid=valid)
    taxon = torch.empty(query.shape, dtype=torch.int32, device=dev)
    taxon_dense = torch.empty(query.shape, dtype=torch.int32, device=dev)
    _kernels.launch("bsearch_lookup", dev, keys, vals, vals_dense, offsets, query, bins, valid,
                    taxon, taxon_dense, query.numel(), keys.numel(), offsets.numel() - 1, n_iter,
                    bin_start)
    return taxon, taxon_dense
