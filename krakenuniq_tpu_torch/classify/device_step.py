"""The classify step on one padded read batch, on a torch device.

Counterpart of krakenuniq_tpu/classify/device_step.py (classify_step_core)
for the resident CHD-hash path with no RLE packing (max_runs = 0):
  2-bit windows -> canonical k-mers -> murmur hashes + HLL encodings
  (`kmer_front` kernel) -> CHD lookup per database, hierarchically
  (`chd_probe` kernel) -> per-read tree resolution (`scores` kernel).

The returned dict carries what the host text/report layer needs, with the
JAX step's keys: uint32 planes come back as int32 bit patterns (read them on
the host with `.numpy().view(np.uint32)`).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _kernels
from ..ints import clz64, i32_to_u32, lsr, s64, u32_to_i32
from ..kmer import ops as kops
from ..lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain
from ..taxonomy.resolve import resolve_reads
from ..utils.bits import P_PRIME

_MUR1 = s64(0xFF51AFD7ED558CCD)
_MUR2 = s64(0xC4CEB9FE1A85EC53)


def murmur3_finalizer_device(key: torch.Tensor) -> torch.Tensor:
    """The HLL bit mixer (hyperloglogplus.cpp:830-838) on int64 planes."""
    key = key + 1
    key = key ^ lsr(key, 33)
    key = key * _MUR1
    key = key ^ lsr(key, 33)
    key = key * _MUR2
    key = key ^ lsr(key, 33)
    return key


def encode_hash_device(h: torch.Tensor, p: int) -> torch.Tensor:
    """The 32-bit sparse HLL encoding (hyperloglogplus.cpp:181-204) of int64
    hashes, as int32 bit patterns."""
    idx = lsr(h, 64 - P_PRIME) << (32 - P_PRIME)  # < 2^32
    flagged = ((idx << p) & 0xFFFFFFFF) == 0
    shifted = h << P_PRIME
    clz = torch.clamp(clz64(shifted), max=64 - P_PRIME)  # clz64(0) = 64
    enc = torch.where(flagged, idx | ((clz + 1) << 1) | 1, idx)
    return u32_to_i32(enc)


def kmer_front_plain(codes: torch.Tensor, ambig: torch.Tensor, k: int, p: int):
    """Plain version of `kmer_front`: (hash int64, enc int32, kmer_ambig
    bool), each [B, LB-k+1]."""
    canon = kops.canonical_representation(kops.pack_windows(codes, k), k)
    hashes = murmur3_finalizer_device(canon)
    return hashes, encode_hash_device(hashes, p), kops.window_any(ambig, k)


def pack_input(codes: torch.Tensor, ambig: torch.Tensor):
    """(B, LB) codes and flags -> the bit-packed feed of
    kuniq_native.encode_unit_packed as int32 bit patterns: base j in bits
    2(j % 16) of code word j / 16, its flag in bit j % 32 of flag word j / 32;
    rows padded with zero codes and flags to a multiple of 32 bases."""
    b, lb = codes.shape
    lbp = -(-lb // 32) * 32
    c = torch.zeros((b, lbp), dtype=torch.int64, device=codes.device)
    a = torch.zeros((b, lbp), dtype=torch.int64, device=codes.device)
    c[:, :lb] = codes
    a[:, :lb] = ambig
    sh = torch.arange(32, device=codes.device)
    cw = (c.view(b, lbp // 16, 16) << (2 * sh[:16])).sum(dim=2)
    aw = (a.view(b, lbp // 32, 32) << sh).sum(dim=2)
    return u32_to_i32(cw), u32_to_i32(aw)


_I64_MIN = -(1 << 63)


def _words64(words32: torch.Tensor) -> torch.Tensor:
    """int32 [B, n] words of a bit string -> int64 words (pairs low-first),
    with at least one zero word past the data."""
    w = i32_to_u32(words32)
    w = torch.nn.functional.pad(w, (0, 4 - w.shape[1] % 2))
    return w[:, 0::2] | (w[:, 1::2] << 32)


def _window64(s64: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Bits [bit, bit + 64) of each row's bit string: the funnel shift of
    two adjacent words, every shift below 64."""
    w, sh = bit >> 6, bit & 63
    lo, hi = s64[:, w], s64[:, w + 1]
    lo = (lo >> sh) & ~((torch.full_like(sh, _I64_MIN) >> sh) << 1)  # logical shift
    return lo | ((hi << 1) << (63 - sh))


def kmer_front_packed(codes_packed: torch.Tensor, ambig_packed: torch.Tensor, lb: int, k: int, p: int):
    """The `kmer_front` kernel's algorithm in plain torch, from the packed
    feed (`pack_input`) of rows of `lb` bases: per lane l the code window
    r = sum c[l + t] << 2t and flag window from one funnel shift each, the
    reverse complement (~r) & (2^2k - 1), the forward k-mer as the 2-bit
    reversal of r; then canonical min, murmur and the HLL encoding. Returns
    what `kmer_front` returns."""
    lane = torch.arange(lb - k + 1, device=codes_packed.device)
    r = _window64(_words64(codes_packed), 2 * lane) & ((1 << 2 * k) - 1)
    amb = (_window64(_words64(ambig_packed), lane) & ((1 << k) - 1)) != 0
    x = r  # 2-bit reversal (the kernel: a bit reversal, then swap adjacent bits)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x >> sh) & m) | ((x & m) << sh)
    x = lsr(x, 32) | (x << 32)
    fwd = lsr(x, 64 - 2 * k)
    rc = ~r & ((1 << 2 * k) - 1)
    hashes = murmur3_finalizer_device(torch.minimum(fwd, rc))
    return hashes, encode_hash_device(hashes, p), amb


def kmer_front(codes: torch.Tensor, ambig: torch.Tensor, k: int, p: int):
    """Canonical k-mer hashes, their HLL encodings and the per-k-mer
    ambiguity of a (B, LB) batch of 2-bit codes (uint8 in 0..3) and base
    ambiguity flags (bool). CUDA tensors launch the `kmer_front` kernel
    (csrc/kmer_front.cu; `kmer_front_packed` is its algorithm in torch)."""
    if codes.device.type == "cpu":
        return kmer_front_plain(codes, ambig, k, p)
    dev = _kernels.check_cuda("kmer_front", codes=codes, ambig=ambig)
    if codes.dtype != torch.uint8 or ambig.dtype != torch.bool or codes.dim() != 2:
        raise TypeError("kmer_front: codes must be uint8 [B, LB] and ambig bool")
    if codes.shape != ambig.shape:
        raise ValueError(f"kmer_front: shapes {tuple(codes.shape)} != {tuple(ambig.shape)}")
    b, lb = codes.shape
    if not 1 <= k <= 31 or lb < k or not 0 <= p < 32:
        raise ValueError(f"kmer_front: need 1 <= k <= 31, LB >= k, 0 <= p < 32 (k={k}, LB={lb}, p={p})")
    w = lb - k + 1
    hashes = torch.empty((b, w), dtype=torch.int64, device=dev)
    enc = torch.empty((b, w), dtype=torch.int32, device=dev)
    kmer_ambig = torch.empty((b, w), dtype=torch.bool, device=dev)
    _kernels.launch("kmer_front", dev, codes, ambig, hashes, enc, kmer_ambig, b, lb, k, p)
    return hashes, enc, kmer_ambig


@dataclasses.dataclass(frozen=True)
class StepConfig:
    k: int
    max_depth: int  # bounds the tie-LCA walk
    hll_p: int = 12
    quick: bool = False
    min_hits: int = 1


def classify_step_core(
    db_planes,  # tuple of (disp4, rows) CHD planes per database, in hierarchy order
    taxid_table: torch.Tensor,  # int32 [T]: device id -> original taxid (uint32 bits)
    io: torch.Tensor,  # int32 [T, 2]: Euler (tin, tout) per id
    parent: torch.Tensor,
    root_dense: int,
    codes: torch.Tensor,  # uint8 [B, LB]
    ambig: torch.Tensor,  # bool [B, LB]
    lengths: torch.Tensor,  # int32 [B]
    cfg: StepConfig,
    plain: bool = False,
):
    """One classify step. `plain=True` runs the plain PyTorch version of
    every kernel on any device, for holding the kernels against it."""
    k = cfg.k
    b, lb = codes.shape
    w = lb - k + 1
    front = kmer_front_plain if plain else kmer_front
    lookup = hash_lookup_plain if plain else hash_lookup_kmers
    hashes, enc, kmer_ambig = front(codes, ambig, k, cfg.hll_p)

    pos = torch.arange(w, dtype=torch.int32, device=codes.device)[None, :]
    n_kmers = torch.clamp(lengths - (k - 1), min=0)[:, None]  # 0 if read shorter than k
    valid = pos < n_kmers

    search = valid & ~kmer_ambig
    taxon_dense = torch.zeros((b, w), dtype=torch.int32, device=codes.device)
    found = torch.zeros((b, w), dtype=torch.bool, device=codes.device)
    # hierarchical multi-DB: later DBs only fill lanes still unclassified
    # (classify.cpp:927-936)
    for plane in db_planes:
        remaining = search & ~found
        word = lookup(plane, hashes, remaining)
        taxon_dense = torch.where(remaining, word, taxon_dense)
        found = found | (word != 0)
    # stored values are device ids; original taxids for the hit-list planes
    # (taxid_table[0] == 0, so misses map to 0)
    taxon = taxid_table[taxon_dense.long()]
    hit = found

    if cfg.quick:
        # stop after min_hits DB hits (classify.cpp:941-963): a k-mer position
        # is processed iff fewer than min_hits hits occurred strictly before it
        hit_i = hit.to(torch.int32)
        hits_before = torch.cumsum(hit_i, dim=1, dtype=torch.int32) - hit_i
        processed = valid & (hits_before < cfg.min_hits)
        total_hits = (hit & processed).sum(dim=1, dtype=torch.int32)
        # the call is the taxon of the hit that reached min_hits
        reach = (hits_before + hit_i == cfg.min_hits) & hit & processed
        call_pos = reach.to(torch.int32).argmax(dim=1, keepdim=True)
        call_dense_taxon = torch.gather(taxon_dense, 1, call_pos)[:, 0]
        call_dense = torch.where(
            total_hits >= cfg.min_hits, call_dense_taxon, torch.zeros_like(call_dense_taxon)
        )
    else:
        processed = valid
        total_hits = hit.sum(dim=1, dtype=torch.int32)
        call_dense = resolve_reads(
            taxon_dense, hit & processed, io, parent, root_dense, cfg.max_depth,
            plain=plain,
        )
    call = taxid_table[call_dense.long()]

    # HLL: every processed non-ambiguous k-mer is counted, including misses
    # under taxon 0 (classify.cpp:939)
    hll_lanes = processed & ~kmer_ambig
    return {
        "taxa": taxon,
        "taxa_dense": taxon_dense,
        "ambig": kmer_ambig,
        "processed": processed,
        "hll_lanes": hll_lanes,
        "enc": enc,
        "call": call,
        "call_dense": call_dense,
        "hits": total_hits,
        "n_kmers": n_kmers[:, 0],
    }
