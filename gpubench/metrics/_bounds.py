"""The least time each of the port's kernels could take on one H100: the
larger of the bytes the function must move over the memory rate and the
integer operations it must issue over the integer rate. A frozen copy of
the arithmetic `chip_smoke.py` holds each kernel against (its `bound`,
`front_words_bound`, `probe_bound`, `scores_bound`, `rle_bound`,
`rle_hll_bound` and `probe_acc_bound`), counting each input byte the
function needs once, whatever implements it.

Peaks:
  * HBM_BYTES_PER_S: 3.35 TB/s, NVIDIA's H100 SXM data sheet;
  * INT_OPS_PER_S: the Hopper SM counts, not the data sheet (which gives
    no integer rate outside the tensor cores): 132 SMs x 64 INT32 lanes a
    clock (CUDA C++ Programming Guide, arithmetic instruction throughput of
    compute capability 9.0) x 1.98 GHz boost = 16.7 T operations/s.
Both assume the card at its full 700 W; a run prints the card's power
limit beside every share.

Each function takes the launch's own tensors and returns the bound in
milliseconds as a 0-dimensional tensor on their device, so that a traced
window never waits for the card to read it.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9

# kmer_front's integer operations a lane: the block-local index (4), two
# funnel-shift windows (12), the ambiguity test (1), the 2-bit reversal (7),
# the reverse complement (2), the minimum (1), murmur (9), the encoder
# (~10) and three stores
FRONT_OPS_PER_LANE = 49
# pack_runs' integer operations a valid lane: loads, shuffles and the code
# compare (3), the ballot and prefix popcount (3), the run index and slot
# tests (3), the step's carry (2)
RLE_OPS_PER_LANE = 13


def bound_ms(bytes_moved, ops) -> torch.Tensor:
    """Numbers or 0-dimensional tensors (all on one device)."""
    dev = next((x.device for x in (bytes_moved, ops) if isinstance(x, torch.Tensor)), None)
    b = torch.as_tensor(bytes_moved, dtype=torch.float64, device=dev)
    o = torch.as_tensor(ops, dtype=torch.float64, device=dev)
    return torch.maximum(b / HBM_BYTES_PER_S, o / INT_OPS_PER_S) * 1e3


def front_words(b: int, lb: int, k: int, canon: bool = False) -> torch.Tensor:
    """kmer_front on the packed feed: 3 bits a base in; hash, encoding and
    flag out (8 + 4 + 1 bytes a lane, 8 more with the canon plane)."""
    lanes = b * (lb - k + 1)
    return bound_ms(b * lb * 3 // 8 + (21 if canon else 13) * lanes, FRONT_OPS_PER_LANE * lanes)


def probe(valid: torch.Tensor) -> torch.Tensor:
    """chd_probe: hash (8 B) and flag (1 B) in, value (4 B) out a query; a
    valid query reads one 4 B displacement word and one 16 B row and issues
    ~24 operations."""
    nv = valid.sum(dtype=torch.float64)
    return bound_ms(13 * valid.numel() + 20 * nv, 24 * nv)


def scores(hit: torch.Tensor) -> torch.Tensor:
    """scores: tin, tout and score (4 B each) and the hit byte a lane; per
    row of H hits, 4 H log2 H compares (two sorts and two searches a hit)."""
    b, w = hit.shape
    n = hit.sum(dim=1, dtype=torch.float64)
    return bound_ms(13.0 * b * w, (4 * n * n.clamp(min=1).log2()).sum())


def rle(n_kmers: torch.Tensor, w: int, cols: int, hll16: bool, stop_given: bool) -> torch.Tensor:
    """pack_runs: an id (4 B) and a flag byte a valid lane, 12 B a read in
    and a row of `cols` u32 words out; with the fused HLL feed also 2 B a
    lane of [B, W] out and, with its own stop tensor, 4 B a read in."""
    b = n_kmers.numel()
    valid = n_kmers.clamp(min=0, max=w).sum(dtype=torch.float64)
    extra = (2 * b * w + (4 * b if stop_given else 0)) if hll16 else 0
    return bound_ms(5 * valid + 12 * b + 4 * b * cols + extra, RLE_OPS_PER_LANE * valid)


def probe_acc(lb: int, k: int, nt: int, in_read, unset_rows, probed, hits, plane_bytes) -> torch.Tensor:
    """chd_probe_acc, one chunk pass over a span: the acc word (4 B) of each
    lane in its read; the packed words (3 bits a base) and length of each
    row with a lane still 0, and its bins' work (13 operations an nt-mer, 6
    a lane); for each probed lane a 32 B sector of each table plane, but no
    more than the plane, and ~33 operations; the acc word out where it hit.
    `plane_bytes`: the chunk table's planes' sizes."""
    table = sum(torch.clamp(32 * probed, max=float(pb)) for pb in plane_bytes)
    moved = 4 * in_read + unset_rows * (lb * 3 // 8 + 4) + table + 4 * hits
    ops = unset_rows * (13 * (lb - nt + 1) + 6 * (lb - k + 1)) + 33 * probed
    return bound_ms(moved, ops)
