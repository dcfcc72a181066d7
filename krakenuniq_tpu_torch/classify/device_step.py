"""The classify step on one padded read batch, on a torch device.

Counterpart of krakenuniq_tpu/classify/device_step.py (classify_step_core)
for the resident CHD-hash path:
  2-bit windows (or the span route's packed words) -> canonical k-mers ->
  murmur hashes + HLL encodings (`kmer_front` kernel) -> CHD lookup per
  database, hierarchically (`chd_probe` kernel; `fused_probe` on a table
  that fell back to the fused layout), or the binary search over the sorted
  planes of databases whose table build failed (lookup_mode "bsearch": on
  the span route's packed feed one `bsearch_words` kernel a database, which
  forms the canonical k-mers and minimizer bins from the words itself and
  searches; on the unpacked feed the `kmer_bins` kernel, then the
  `bsearch_lookup` kernel), or out of core the span's
  word plane that `probe_chunk_core` accumulated over the chunk tables
  (`chd_probe_acc` kernel: the k-mer front, the minimizer bins and the
  probe of the lanes whose bin the chunk owns, in one pass over the span's
  packed feed; lookup_mode "acc") -> per-read tree resolution
  (`scores` kernel) -> with max_runs > 0, RLE rows (`pack_runs` kernel),
  over a per-span taxon dictionary when the ids pass u16 (`span_dict`
  kernel). `classify_and_count_core` adds the --device-counters update
  (`taxon_counts`, `hll_regmax` and `sparse_stats` kernels) on the same
  stream. With `with_kmers` (--exact) the step also returns the canonical
  k-mers from `kmer_front`'s optional canon plane; with `resolve=False`
  (the long-read step) it skips the tree resolution and returns zero calls.
Under a mesh (`mesh=`, parallel/mesh.py) the step and `probe_chunk_core`
run on a rank's rows and db shard with the same kernels; the words merge
over the rank's db group and a span dictionary over its data group.

The returned dict carries what the host text/report layer needs, with the
JAX step's keys: uint32 planes come back as int32 bit patterns (read them on
the host with `.numpy().view(np.uint32)`), the u16 `hll_dense` plane as
int16 bit patterns (`.view(np.uint16)`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _kernels
from ..ints import clz64, i32_to_u32, lsr, s64, u32_to_i32
from ..kmer import ops as kops
from ..lookup.hash_lookup import (
    _chd_widths,
    _raw_width,
    hash_lookup_acc_plain,
    hash_lookup_kmers,
    hash_lookup_plain,
    table_layout,
)
from ..lookup.xla_lookup import lookup_kmers, lookup_kmers_plain
from ..taxonomy.resolve import resolve_reads
from ..utils.bits import INDEX2_XOR_MASK, P_PRIME

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


def kmer_front_plain(codes: torch.Tensor, ambig: torch.Tensor, k: int, p: int, canon: bool = False):
    """Plain version of `kmer_front`: (hash int64, enc int32, kmer_ambig
    bool), each [B, LB-k+1], and with `canon` the canonical k-mers (int64)
    last."""
    kmers = kops.canonical_representation(kops.pack_windows(codes, k), k)
    hashes = murmur3_finalizer_device(kmers)
    out = (hashes, encode_hash_device(hashes, p), kops.window_any(ambig, k))
    return (*out, kmers) if canon else out


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


def kmer_front_packed(codes_packed: torch.Tensor, ambig_packed: torch.Tensor, lb: int, k: int, p: int,
                      canon: bool = False):
    """The `kmer_front` kernel's algorithm in plain torch, from the packed
    feed (`pack_input`) of rows of `lb` bases: per lane l the code window
    r = sum c[l + t] << 2t and flag window from one funnel shift each, the
    reverse complement (~r) & (2^2k - 1), the forward k-mer as the 2-bit
    reversal of r; then canonical min, murmur and the HLL encoding. Returns
    what `kmer_front` returns."""
    lane = torch.arange(lb - k + 1, device=codes_packed.device)
    amb = (_window64(_words64(ambig_packed), lane) & ((1 << k) - 1)) != 0
    kmers = _canonical_windows(_words64(codes_packed), lane, k)
    hashes = murmur3_finalizer_device(kmers)
    out = (hashes, encode_hash_device(hashes, p), amb)
    return (*out, kmers) if canon else out


def _canonical_windows(s64: torch.Tensor, first: torch.Tensor, n: int) -> torch.Tensor:
    """The canonical n-mers (n <= 31) starting at bases `first` of each row's
    staged code string: the window r = sum c[f + t] << 2t from one funnel
    shift, the reverse complement (~r) & (4^n - 1), the forward n-mer the
    2-bit reversal of r (the kernel: a bit reversal, then swap adjacent
    bits), and the smaller of the two."""
    r = _window64(s64, 2 * first) & ((1 << 2 * n) - 1)
    x = r
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x >> sh) & m) | ((x & m) << sh)
    x = lsr(x, 32) | (x << 32)
    return torch.minimum(lsr(x, 64 - 2 * n), ~r & ((1 << 2 * n) - 1))


def _unpack_codes(codes_packed: torch.Tensor) -> torch.Tensor:
    """int32 [B, LB/16] code words -> uint8 [B, LB] codes."""
    b, lbw = codes_packed.shape
    c = i32_to_u32(codes_packed)[:, :, None] >> (2 * torch.arange(16, device=codes_packed.device))
    return (c & 3).to(torch.uint8).reshape(b, lbw * 16)


def unpack_input(codes_packed: torch.Tensor, ambig_packed: torch.Tensor):
    """The packed feed (int32 [B, LB/16] code words, [B, LB/32] flag words
    of kuniq_native.encode_unit_packed) -> the (B, LB) uint8 codes and bool
    flags (krakenuniq_tpu/classify/device_step.py:54-70)."""
    a = i32_to_u32(ambig_packed)[:, :, None] >> torch.arange(32, device=ambig_packed.device)
    return _unpack_codes(codes_packed), ((a & 1) != 0).reshape(codes_packed.shape[0], -1)


def _front_outputs(b: int, w: int, dev, canon: bool):
    """The kernel's output planes: hashes, encodings, k-mer ambiguity and,
    with `canon`, the canonical k-mers (else None: not written)."""
    return (torch.empty((b, w), dtype=torch.int64, device=dev), torch.empty((b, w), dtype=torch.int32, device=dev),
            torch.empty((b, w), dtype=torch.bool, device=dev),
            torch.empty((b, w), dtype=torch.int64, device=dev) if canon else None)


def kmer_front(codes: torch.Tensor, ambig: torch.Tensor, k: int, p: int, canon: bool = False):
    """Canonical k-mer hashes, their HLL encodings and the per-k-mer
    ambiguity of a (B, LB) batch of 2-bit codes (uint8 in 0..3) and base
    ambiguity flags (bool); with `canon`, the canonical k-mers (int64, below
    2^62) last, from the same launch. CUDA tensors launch the `kmer_front`
    kernel (csrc/kmer_front.cu; `kmer_front_packed` is its algorithm in
    torch)."""
    if codes.device.type == "cpu":
        return kmer_front_plain(codes, ambig, k, p, canon)
    dev = _kernels.check_cuda("kmer_front", codes=codes, ambig=ambig)
    if codes.dtype != torch.uint8 or ambig.dtype != torch.bool or codes.dim() != 2:
        raise TypeError("kmer_front: codes must be uint8 [B, LB] and ambig bool")
    if codes.shape != ambig.shape:
        raise ValueError(f"kmer_front: shapes {tuple(codes.shape)} != {tuple(ambig.shape)}")
    b, lb = codes.shape
    if not 1 <= k <= 31 or lb < k or not 0 <= p < 32:
        raise ValueError(f"kmer_front: need 1 <= k <= 31, LB >= k, 0 <= p < 32 (k={k}, LB={lb}, p={p})")
    out = _front_outputs(b, lb - k + 1, dev, canon)
    _kernels.launch("kmer_front", dev, codes, ambig, *out, b, lb, k, p)
    return out if canon else out[:3]


def kmer_front_words(codes_packed: torch.Tensor, ambig_packed: torch.Tensor, k: int, p: int,
                     canon: bool = False):
    """`kmer_front` on the span route's packed feed: int32 [B, LB/16] code
    words and [B, LB/32] flag words (encode_unit_packed's layout, LB a
    multiple of 32). CUDA tensors launch the kernel's packed entry point,
    which stages the words as they are; CPU tensors run `kmer_front_packed`."""
    if codes_packed.dim() != 2 or ambig_packed.dim() != 2:
        raise TypeError("kmer_front_words: codes and ambig must be [B, words]")
    b, lbw = codes_packed.shape
    lb = 16 * lbw
    if ambig_packed.shape != (b, lbw // 2) or lbw % 2:
        raise ValueError(
            f"kmer_front_words: need [B, LB/16] codes and [B, LB/32] flags with LB a "
            f"multiple of 32, got {tuple(codes_packed.shape)} and {tuple(ambig_packed.shape)}"
        )
    if not 1 <= k <= 31 or lb < k or not 0 <= p < 32:
        raise ValueError(f"kmer_front_words: need 1 <= k <= 31, LB >= k, 0 <= p < 32 (k={k}, LB={lb}, p={p})")
    if codes_packed.device.type == "cpu":
        return kmer_front_packed(codes_packed, ambig_packed, lb, k, p, canon)
    dev = _kernels.check_cuda("kmer_front", codes=codes_packed, ambig=ambig_packed)
    if codes_packed.dtype != torch.int32 or ambig_packed.dtype != torch.int32:
        raise TypeError("kmer_front_words: the words must be int32")
    out = _front_outputs(b, lb - k + 1, dev, canon)
    _kernels.launch("kmer_front_packed", dev, codes_packed, ambig_packed, *out, b, lb, k, p)
    return out if canon else out[:3]


def kmer_bins_plain(codes: torch.Tensor, k: int, nt: int):
    """Plain version of `kmer_bins`: (canonical k-mers, minimizer bins),
    both int64 [B, LB-k+1], by pack_windows, canonical_representation and
    minimizers (krakenuniq_tpu/kmer/ops.py)."""
    canon = kops.canonical_representation(kops.pack_windows(codes, k), k)
    return canon, kops.minimizers(codes, k, nt)


def kmer_bins_sliding(codes_packed: torch.Tensor, lb: int, k: int, nt: int):
    """The `kmer_bins` kernel's algorithm in plain torch, from packed code
    words (`pack_input`) of rows of `lb` bases: phase A, one value per base
    position f < lb - nt + 1, xm ^ the canonical nt-mer at f (xm =
    INDEX2_XOR_MASK & (4^nt - 1)); phase B, the sliding minimum over w = k -
    nt + 1 values (van Herk/Gil-Werman): within blocks of w values from each
    row's start a prefix minimum P and a suffix minimum S, so that the bin of
    lane l is min(S[l], P[l + w - 1]). The canonical k-mer is the lane's own
    window. Returns what `kmer_bins` returns."""
    s64 = _words64(codes_packed)
    dev = codes_packed.device
    nv, w, n_lanes = lb - nt + 1, k - nt + 1, lb - k + 1
    xm = int(INDEX2_XOR_MASK) & ((1 << 2 * nt) - 1)
    vals = xm ^ _canonical_windows(s64, torch.arange(nv, device=dev), nt)
    nseg = -(-nv // w)
    v = torch.nn.functional.pad(vals, (0, nseg * w - nv), value=torch.iinfo(torch.int64).max)
    v = v.view(-1, nseg, w)
    prefix = torch.cummin(v, dim=2).values.flatten(1)
    suffix = torch.cummin(v.flip(2), dim=2).values.flip(2).flatten(1)
    bins = torch.minimum(suffix[:, :n_lanes], prefix[:, w - 1 : w - 1 + n_lanes])
    return _canonical_windows(s64, torch.arange(n_lanes, device=dev), k), bins


def _bins_check(name: str, k: int, nt: int, lb: int) -> None:
    if not 1 <= nt <= k <= 31 or lb < k:
        raise ValueError(f"{name}: need 1 <= nt <= k <= 31 and LB >= k (k={k}, nt={nt}, LB={lb})")


def kmer_bins(codes: torch.Tensor, k: int, nt: int):
    """The canonical k-mer (int64, below 2^62) and its minimizer bin (int64,
    below 4^nt: the minimum of INDEX2_XOR_MASK & (4^nt - 1) ^ canonical
    nt-mer over the window's k - nt + 1 nt-mers) of every lane of a (B, LB)
    uint8 code batch. CUDA tensors launch the `kmer_bins` kernel (csrc/
    kmer_front.cu); CPU tensors run `kmer_bins_plain`."""
    if codes.dim() != 2:
        raise TypeError("kmer_bins: codes must be [B, LB]")
    b, lb = codes.shape
    _bins_check("kmer_bins", k, nt, lb)
    if codes.device.type == "cpu":
        return kmer_bins_plain(codes, k, nt)
    dev = _kernels.check_cuda("kmer_bins", codes=codes)
    if codes.dtype != torch.uint8:
        raise TypeError("kmer_bins: codes must be uint8")
    canon = torch.empty((b, lb - k + 1), dtype=torch.int64, device=dev)
    bins = torch.empty_like(canon)
    _kernels.launch("kmer_bins", dev, codes, canon, bins, b, lb, k, nt)
    return canon, bins


def kmer_bins_words(codes_packed: torch.Tensor, k: int, nt: int):
    """`kmer_bins` on the span route's packed code words (int32 [B, LB/16],
    LB a multiple of 32). CUDA tensors launch the kernel's packed entry;
    CPU tensors unpack the words and run `kmer_bins_plain`."""
    if codes_packed.dim() != 2 or codes_packed.shape[1] % 2:
        raise ValueError("kmer_bins_words: need [B, LB/16] code words with LB a multiple of 32")
    b, lbw = codes_packed.shape
    lb = 16 * lbw
    _bins_check("kmer_bins_words", k, nt, lb)
    if codes_packed.device.type == "cpu":
        return kmer_bins_plain(_unpack_codes(codes_packed), k, nt)
    dev = _kernels.check_cuda("kmer_bins", codes=codes_packed)
    if codes_packed.dtype != torch.int32:
        raise TypeError("kmer_bins_words: the words must be int32")
    canon = torch.empty((b, lb - k + 1), dtype=torch.int64, device=dev)
    bins = torch.empty_like(canon)
    _kernels.launch("kmer_bins_packed", dev, codes_packed, canon, bins, b, lb, k, nt)
    return canon, bins


# the RLE row layouts of `pack_runs` (csrc/pack_runs.cu) and their codes in
# the kernel
_LAYOUTS = {"compact": 0, "dense": 1, "wide": 2}


def pack_runs_cols(layout: str, r: int) -> int:
    """Words in a `layout` row with r run slots."""
    return {"compact": r + 1, "dense": r + 2, "wide": r + r // 2 + 3}[layout]


def _pack_runs_check(ids, n_kmers, max_runs: int, layout: str, hll16: bool, hll_stop) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(f"pack_runs: layout must be one of {sorted(_LAYOUTS)}, got {layout!r}")
    if max_runs <= 0 or max_runs % 2:
        raise ValueError("max_runs must be even and positive (paired 16-bit run lengths)")
    if ids.dim() != 2 or ids.shape[1] >= 1 << 15:
        raise ValueError("RLE packing supports at most 2^15-1 k-mers per read")
    if hll_stop is not None:
        if not hll16:
            raise ValueError("pack_runs: hll_stop belongs to the hll16 feed")
        if hll_stop.shape != n_kmers.shape or hll_stop.dtype != torch.int32:
            raise ValueError("pack_runs: hll_stop must be int32 [B], as n_kmers")


def hll_feed_plain(ids, kmer_ambig, hll_stop):
    """The span step's u16 HLL feed as int16 bits: ids & 0xFFFF on the
    counted lanes (lane l < hll_stop[b], not ambiguous), 0xFFFF elsewhere
    (krakenuniq_tpu/classify/device_step.py:389-391, with the processed
    lanes a prefix of each read)."""
    lane = torch.arange(ids.shape[1], device=ids.device)
    counted = (lane[None, :] < hll_stop[:, None]) & ~kmer_ambig
    return torch.where(counted, ids & 0xFFFF, 0xFFFF).to(torch.int16)


def pack_runs_plain(ids, kmer_ambig, n_kmers, call, hits, max_runs: int, layout: str,
                    map_table=None, hll16: bool = False, hll_stop=None):
    """Plain version of `pack_runs`: the JAX package's `_pack_runs`
    (krakenuniq_tpu/classify/device_step.py:408-490) in torch, a cumsum of
    the change flags and masked reductions over the R run slots; with
    `hll16`, also `hll_feed_plain`."""
    _pack_runs_check(ids, n_kmers, max_runs, layout, hll16, hll_stop)
    b, w = ids.shape
    r = max_runs
    dev = ids.device
    idl = i32_to_u32(ids)
    valid = torch.arange(w, device=dev)[None, :] < n_kmers[:, None]
    code = torch.where(kmer_ambig, -1, idl)
    code = torch.where(valid, code, -2)
    prev = torch.cat([torch.full((b, 1), -3, dtype=code.dtype, device=dev), code[:, :-1]], dim=1)
    change = (code != prev) & valid
    run_id = torch.cumsum(change, dim=1, dtype=torch.int32) - 1
    n_runs = torch.where(valid, run_id, -1).max(dim=1).values.long() + 1
    in_slot = valid[:, None, :] & (run_id[:, None, :] == torch.arange(r, device=dev)[None, :, None])
    run_lens = in_slot.sum(dim=2)
    run_amb = (in_slot & kmer_ambig[:, None, :]).any(dim=2).long() << 15
    run_ids = torch.where(in_slot, idl[:, None, :], 0).max(dim=2).values
    call_u, hits_u = i32_to_u32(call), i32_to_u32(hits)
    meta = ((hits_u << 16) | n_runs) & 0xFFFFFFFF
    if layout != "wide":
        words = ((run_ids << 16) & 0xFFFFFFFF) | run_amb | run_lens
        if layout == "compact":
            tail = [((call_u << 16) & 0xFFFFFFFF) | n_runs]
        else:
            tail = [call_u, meta]
        rows = u32_to_i32(torch.cat([words] + [t[:, None] for t in tail], dim=1))
    else:
        run_vals = run_ids
        if map_table is not None:
            n_map = map_table.shape[0]
            run_vals = torch.where(
                run_ids < n_map, i32_to_u32(map_table)[run_ids.clamp(max=max(n_map - 1, 0))], 0
            )
        lens16 = run_lens | run_amb
        lens2 = lens16[:, 0::2] | (lens16[:, 1::2] << 16)
        tail = [call_u, i32_to_u32(n_kmers), meta]
        rows = u32_to_i32(torch.cat([run_vals, lens2] + [t[:, None] for t in tail], dim=1))
    if not hll16:
        return rows
    return rows, hll_feed_plain(ids, kmer_ambig, n_kmers if hll_stop is None else hll_stop)


def pack_runs(ids, kmer_ambig, n_kmers, call, hits, max_runs: int, layout: str, map_table=None,
              hll16: bool = False, hll_stop=None):
    """Each read's RLE row, int32 [B, cols] (u32 bit patterns; layouts in
    csrc/pack_runs.cu): ids int32 [B, W] (dense ids), kmer_ambig bool
    [B, W], n_kmers, call and hits int32 [B], map_table int32 [T] (wide
    layout only, optional). With `hll16`, returns (rows, feed): the feed is
    int16 [B, W], ids & 0xFFFF on lanes below hll_stop (int32 [B], at most
    n_kmers; None: n_kmers) that are not ambiguous and 0xFFFF elsewhere.
    CUDA tensors launch the `pack_runs` kernel; CPU tensors run
    `pack_runs_plain`. Needs W < 2^15 and an even R."""
    if ids.device.type == "cpu":
        return pack_runs_plain(ids, kmer_ambig, n_kmers, call, hits, max_runs, layout, map_table,
                               hll16, hll_stop)
    _pack_runs_check(ids, n_kmers, max_runs, layout, hll16, hll_stop)
    if map_table is not None and layout != "wide":
        raise ValueError("pack_runs: map_table belongs to the wide layout")
    tensors = dict(ids=ids, kmer_ambig=kmer_ambig, n_kmers=n_kmers, call=call, hits=hits)
    if map_table is not None:
        tensors["map_table"] = map_table
    if hll_stop is not None:
        tensors["hll_stop"] = hll_stop
    dev = _kernels.check_cuda("pack_runs", **tensors)
    if kmer_ambig.dtype != torch.bool or any(
        t.dtype != torch.int32 for k, t in tensors.items() if k != "kmer_ambig"
    ):
        raise TypeError("pack_runs: kmer_ambig must be bool and the rest int32")
    b, w = ids.shape
    if kmer_ambig.shape != ids.shape or any(t.shape != (b,) for t in (n_kmers, call, hits)):
        raise ValueError("pack_runs: need [B, W] ids and kmer_ambig and [B] n_kmers, call, hits")
    cols = pack_runs_cols(layout, max_runs)
    out = torch.empty((b, cols), dtype=torch.int32, device=dev)
    feed = torch.empty((b, w), dtype=torch.int16, device=dev) if hll16 else None
    n_map = 0 if map_table is None else map_table.shape[0]
    _kernels.launch("pack_runs", dev, ids, kmer_ambig, n_kmers, call, hits, map_table, n_map,
                    out, feed, hll_stop, b, w, max_runs, _LAYOUTS[layout], cols)
    return (out, feed) if hll16 else out


_LUT_PAD = 1 << 30  # above any dense id: keeps the span dictionary sorted


def _span_dict_check(ids, calls, n_ids: int, cap: int) -> None:
    if ids.dim() != 2 or calls.shape != ids.shape[:1]:
        raise ValueError("span_dict: need [B, W] ids and [B] calls")
    if not 0 < cap < 0xFFFF or n_ids <= 0:
        raise ValueError(f"span_dict: need 0 < cap < 0xFFFF (the u16 sentinel) and n_ids > 0 (cap={cap})")


def span_dict_plain(ids, calls, n_ids: int, cap: int, with_call: bool = True):
    """Plain version of `span_dict`: the JAX package's sort, cumsum,
    searchsorted and scatter (krakenuniq_tpu/classify/device_step.py:
    286-370, without the mesh merge) in torch."""
    _span_dict_check(ids, calls, n_ids, cap)
    dev = ids.device
    s = torch.sort(torch.cat([ids.reshape(-1), calls])).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    ranks = torch.cumsum(first, 0, dtype=torch.int32)
    n_u = ranks[-1]
    targets = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(ranks, targets)
    lut = torch.where(targets <= n_u, s[idx.clamp(max=s.numel() - 1)], _LUT_PAD)
    remap = torch.zeros(n_ids, dtype=torch.int32, device=dev)
    keep = (lut >= 0) & (lut < n_ids)  # the scatter's mode="drop"
    remap[lut[keep].long()] = torch.arange(cap, dtype=torch.int32, device=dev)[keep]
    local = remap[ids.long()]
    local_call = remap[calls.long()] if with_call else None
    return torch.cat([lut, n_u[None]]), local, local_call


def _popc32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 held in an int64 tensor (the SWAR popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def span_dict_bitmap(ids, calls, n_ids: int, cap: int, with_call: bool = True, super_words: int = 1024):
    """`span_dict`'s result by the algorithm of its kernels (csrc/
    span_dict.cu), in plain torch: a bit per id of [0, n_ids) set by every
    id of the plane and the calls (ids outside are no entry and remap to 0),
    the set bits counted per superblock of `super_words` words, each word's
    first rank (the superblocks before it plus the words before it in its
    superblock), lut[rank] = id below cap, and each id's rank as its word's
    first rank plus the popcount of the word's bits below it."""
    _span_dict_check(ids, calls, n_ids, cap)
    dev = ids.device
    x = torch.cat([ids.reshape(-1), calls]).to(torch.int64)
    ok = (x >= 0) & (x < n_ids)
    n_words = (n_ids + 31) // 32
    bit = torch.zeros(n_words * 32, dtype=torch.int64, device=dev)
    bit[x[ok]] = 1
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (bit.view(n_words, 32) << shifts).sum(dim=1)  # u32 bit patterns
    pop = _popc32(words)
    n_supers = -(-n_words // super_words)
    per_super = torch.zeros(n_supers * super_words, dtype=torch.int64, device=dev)
    per_super[:n_words] = pop
    per_super = per_super.view(n_supers, super_words)
    super_first = torch.cumsum(per_super.sum(dim=1), 0) - per_super.sum(dim=1)
    first = (super_first[:, None] + torch.cumsum(per_super, 1) - per_super).reshape(-1)[:n_words]
    n_u = int(pop.sum())
    lut = torch.full((cap + 1,), _LUT_PAD, dtype=torch.int32, device=dev)
    set_ids = torch.nonzero(bit).reshape(-1)[:cap]  # ascending: rank order
    lut[: set_ids.numel()] = set_ids.to(torch.int32)
    lut[cap] = n_u
    xs = torch.where(ok, x, torch.zeros_like(x))
    w = xs >> 5
    rank = first[w] + _popc32(words[w] & ((1 << (xs & 31)) - 1))
    local = torch.where(ok & (rank < cap), rank, torch.zeros_like(rank)).to(torch.int32)
    n = ids.numel()
    return lut, local[:n].view(ids.shape), local[n:] if with_call else None


def span_dict(ids, calls, n_ids: int, cap: int, with_call: bool = True):
    """The span's taxon dictionary and its local ids: (lut int32 [cap + 1]:
    the sorted distinct values of ids (int32 [B, W] dense ids in [0,
    n_ids)) and calls (int32 [B]), the first `cap` of them, padded with
    2^30, and their count last; local int32 [B, W]: each id's rank in it,
    0 past cap; local_call int32 [B] likewise, None without `with_call`).
    CUDA tensors launch the `span_dict` kernels (csrc/span_dict.cu: a bit
    per id, the popcount ranks); CPU tensors run `span_dict_plain`."""
    if ids.device.type == "cpu":
        return span_dict_plain(ids, calls, n_ids, cap, with_call)
    _span_dict_check(ids, calls, n_ids, cap)
    dev = _kernels.check_cuda("span_dict", ids=ids, calls=calls)
    if ids.dtype != torch.int32 or calls.dtype != torch.int32:
        raise TypeError("span_dict: ids and calls must be int32")
    lut = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    local = torch.empty_like(ids)
    local_call = torch.empty_like(calls) if with_call else None
    words = _kernels.entry("span_dict", "kuniq_span_dict_scratch", (ctypes.c_int,))(n_ids)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _kernels.launch("span_dict", dev, ids, ids.numel(), calls, calls.numel(), n_ids, cap, lut, local,
                    local_call, scratch)
    return lut, local, local_call


def hll_pairs_feed(ids, enc, hll_lanes):
    """The wide rows' u64 HLL feed as int64 bits: id<<32 | enc on the
    counted lanes, all ones elsewhere (krakenuniq_tpu/classify/
    device_step.py:392-402)."""
    pairs = (ids.to(torch.int64) << 32) | (enc.to(torch.int64) & 0xFFFFFFFF)
    return torch.where(hll_lanes, pairs, torch.full_like(pairs, -1))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    k: int
    max_depth: int  # bounds the tie-LCA walk
    hll_p: int = 12
    quick: bool = False
    min_hits: int = 1
    # the span route's feed: codes and ambig arrive as encode_unit_packed's
    # int32 words ([B, LB/16] codes, [B, LB/32] flags)
    packed_input: bool = False
    # > 0: emit each read's RLE row ("packed", `pack_runs`) with this many
    # run slots (even); reads with more runs report n_runs > max_runs and
    # the host formats them from taxa_dense / ambig
    max_runs: int = 0
    # RLE rows of dense id<<16 | amb<<15 | len words and the u16 hll_dense
    # feed (ids below 2^16: the value pool, a small taxonomy, or local_dict);
    # False: the wide rows (taxids through taxid_table) and the u64
    # hll_pairs feed, the dictionary's overflow route
    dense_runs: bool = False
    # with dense_runs: a per-span taxon dictionary (`span_dict`) over every
    # id the span can emit; rows and the hll_dense feed carry local ids and
    # out["lut"] maps them back ([dict_capacity + 1], the count last). A
    # span with more distinct ids than dict_capacity (< 0xFFFF, the u16
    # sentinel) is redispatched on the wide rows by the host
    local_dict: bool = False
    dict_capacity: int = 1 << 15
    # restrict the returned dict to these keys (None = all)
    outputs: tuple | None = None
    # "hash": probe the resident tables (db_planes: CHD or fused planes per
    # database); "bsearch": search each database's sorted planes (db_planes:
    # (keys, vals, vals_dense, offsets, bin_start) per database, n_iter
    # steps); "acc": out of core, db_planes is the span's merged word plane
    # (probe_chunk_core) and no table is probed
    lookup_mode: str = "hash"
    nt: int = 0  # minimizer length (the bsearch bins)
    n_iter: int = 1  # binary-search trip count (DeviceDB.search_iters)
    # (True,): the one database's table stores raw 32-bit values (a UID
    # database: taxon-set ids, not taxids; searched alone, never in quick
    # mode); its words go to the "taxa" plane as they are, never to
    # taxa_dense, and the wide rows, hll_pairs and the counters key on
    # them. Empty = dense
    raw_dbs: tuple = ()
    # False: no tree resolution on the device (the long-read step, whose
    # per-read resolve would be quadratic in the row's width; the host
    # resolves from the returned per-k-mer taxa): call and call_dense are 0
    resolve: bool = True
    # also return the canonical k-mers, out["canon"] int64 [B, W], from the
    # `kmer_front` launch (--exact)
    with_kmers: bool = False


def _words_check(name, plane, codes, ambig, lengths, k: int, nt: int, taxon, taxon_dense):
    """Check the words entry's operands; returns (B, LB, W)."""
    b, lbw = codes.shape
    lb = 16 * lbw
    if ambig.shape != (b, lbw // 2) or lbw % 2 or lengths.shape != (b,):
        raise ValueError(f"{name}: need [B, LB/16] codes, [B, LB/32] flags and [B] lengths, got "
                         f"{tuple(codes.shape)}, {tuple(ambig.shape)}, {tuple(lengths.shape)}")
    if not 1 <= nt <= k <= 31 or lb < k:
        raise ValueError(f"{name}: need 1 <= nt <= k <= 31 and LB >= k (k={k}, nt={nt}, LB={lb})")
    w = lb - k + 1
    if (taxon is None) != (taxon_dense is None) or (taxon is not None and not (
            taxon.shape == taxon_dense.shape == (b, w))):
        raise ValueError(f"{name}: taxon and taxon_dense are both None or both [B, LB - k + 1] = [{b}, {w}]")
    if len(plane) != 5:
        raise ValueError(f"{name}: a database's plane is (keys, vals, vals_dense, offsets, bin_start)")
    return b, lb, w


def _words_lanes(codes, ambig, lengths, k: int, taxon):
    """The lanes the words entry searches: in the read, free of ambiguous
    bases and, when `taxon` is given, still 0 there; with the unpacked
    codes."""
    codes_u, ambig_u = unpack_input(codes, ambig)
    w = codes_u.shape[1] - k + 1
    pos = torch.arange(w, dtype=torch.int32, device=codes.device)[None, :]
    lanes = (pos < torch.clamp(lengths - (k - 1), min=0)[:, None]) & ~kops.window_any(ambig_u, k)
    if taxon is not None:
        lanes &= taxon == 0
    return codes_u, lanes


def _words_merge(t, td, lanes, taxon, taxon_dense):
    if taxon is None:
        return t, td
    taxon.copy_(torch.where(lanes, t, taxon))
    taxon_dense.copy_(torch.where(lanes, td, taxon_dense))
    return taxon, taxon_dense


def bsearch_words_plain(plane, codes, ambig, lengths, k: int, nt: int, n_iter: int, taxon=None,
                        taxon_dense=None):
    """Plain version of `bsearch_words`: `kmer_bins_plain` on the unpacked
    codes, then `lookup_kmers_plain` over the step's mask of the lanes still
    unclassified (krakenuniq_tpu/classify/device_step.py:157-212)."""
    _words_check("bsearch_words", plane, codes, ambig, lengths, k, nt, taxon, taxon_dense)
    keys, vals, vals_dense, offsets, bin_start = plane
    codes_u, lanes = _words_lanes(codes, ambig, lengths, k, taxon)
    canon, bins = kmer_bins_plain(codes_u, k, nt)
    t, td = lookup_kmers_plain(keys, vals, vals_dense, offsets, canon, bins, lanes, n_iter, bin_start)
    return _words_merge(t, td, lanes, taxon, taxon_dense)


def bsearch_words(plane, codes, ambig, lengths, k: int, nt: int, n_iter: int, taxon=None, taxon_dense=None,
                  plain: bool = False):
    """One database's binary search of a span's lanes from its packed feed:
    codes int32 [B, LB/16] and ambig int32 [B, LB/32] words (LB a multiple
    of 32), lengths int32 [B], `plane` = (keys, vals, vals_dense, offsets,
    bin_start) as `lookup_kmers` takes them. A lane in its read and free of
    ambiguous bases searches its canonical k-mer in its minimizer bin (nt)
    for n_iter steps. With taxon None (the first database), returns new
    (taxon int32 [B, LB - k + 1] (stored uint32 bits), taxon_dense int32), 0
    where not found; else updates the given planes in place, only on the
    lanes still 0 in taxon (a hit is keyed on the stored taxid, so the first
    database's hit wins), and returns them. CUDA tensors launch the
    `bsearch_words` kernel (csrc/bsearch_lookup.cu), which forms the k-mers
    and bins itself: no k-mer or bin plane touches device memory; CPU
    tensors, or `plain`, run `bsearch_words_plain`."""
    if plain or codes.device.type == "cpu":
        return bsearch_words_plain(plane, codes, ambig, lengths, k, nt, n_iter, taxon, taxon_dense)
    b, lb, w = _words_check("bsearch_words", plane, codes, ambig, lengths, k, nt, taxon, taxon_dense)
    keys, vals, vals_dense, offsets, bin_start = plane
    first = taxon is None
    if first:
        taxon = torch.empty((b, w), dtype=torch.int32, device=codes.device)
        taxon_dense = torch.empty_like(taxon)
    dev = _kernels.check_cuda("bsearch_words", codes=codes, ambig=ambig, lengths=lengths, keys=keys, vals=vals,
                              vals_dense=vals_dense, offsets=offsets, taxon=taxon, taxon_dense=taxon_dense)
    if any(t.dtype != torch.int32 for t in (codes, ambig, lengths, vals, vals_dense, taxon, taxon_dense)):
        raise TypeError("bsearch_words: the words, lengths, vals and taxon planes must be int32")
    if keys.dtype != torch.int64 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise TypeError("bsearch_words: keys and offsets must be int64, offsets [n_bins + 1]")
    _kernels.launch("bsearch_words", dev, codes, ambig, lengths, keys, vals, vals_dense, offsets, taxon,
                    taxon_dense, b, lb, w, k, nt, keys.numel(), offsets.numel() - 1, n_iter, int(bin_start),
                    int(first))
    return taxon, taxon_dense


def _front(codes, ambig, cfg: StepConfig, plain: bool):
    """The step's k-mer front on either feed: (hashes, enc, kmer_ambig,
    canon (None without cfg.with_kmers), B, LB)."""
    kw = dict(canon=cfg.with_kmers)
    if cfg.packed_input:
        b, lb = codes.shape[0], 16 * codes.shape[1]
        if plain:
            front = kmer_front_packed(codes, ambig, lb, cfg.k, cfg.hll_p, **kw)
        else:
            front = kmer_front_words(codes, ambig, cfg.k, cfg.hll_p, **kw)
    else:
        b, lb = codes.shape
        front = (kmer_front_plain if plain else kmer_front)(codes, ambig, cfg.k, cfg.hll_p, **kw)
    hashes, enc, kmer_ambig = front[:3]
    return hashes, enc, kmer_ambig, front[3] if cfg.with_kmers else None, b, lb


def probe_chunk_core(
    acc: torch.Tensor,  # int32 [B, W]: the merged word plane so far (updated in place)
    planes,  # one chunk table's (disp4, rows) or raw (ptags, confirm) planes on the step's device
    bounds,  # the chunk's minimizer-bin range [lo, hi) (ChunkedHashDB.bounds)
    codes: torch.Tensor,  # int32 [B, LB/16] packed code words (pack_input's layout)
    ambig: torch.Tensor,  # int32 [B, LB/32] packed flag words
    lengths: torch.Tensor,  # int32 [B]
    k: int,
    nt: int,  # the database's minimizer length
    plain: bool = False,
    mesh=None,  # parallel/mesh.Mesh: this rank probes its chunk of a group of n_db
) -> torch.Tensor:
    """One out-of-core pass, after the JAX package's _probe_chunk_core
    (krakenuniq_tpu/classify/device_step.py:496-531): each lane in its read,
    free of ambiguous bases and still 0 in `acc` takes this chunk table's
    value, acc updated in place and returned (the first nonzero word wins:
    the chunk merge, and the first-database-wins rule when chunks are probed
    in database order). Only the lanes whose minimizer bin (nt-mers, the
    database's own nt) lies in `bounds` are probed: chunks are cut along bin
    ranges, so every other lane's k-mer is a key of another chunk or of
    none, and the exact probe would miss it here; the result equals the JAX
    package's probe of every lane. W <= LB - k + 1. CUDA tensors launch the
    `chd_probe_acc` kernel (`rows_probe_acc` on a raw two-level chunk
    table), which computes the front, the bins and the probe in one pass;
    CPU tensors, or `plain`, run `kmer_front_packed`, `kmer_bins_plain`,
    the range mask and `hash_lookup_acc_plain`.

    Under a mesh with n_db > 1 (OOC x mesh, JAX device_step.py:525-529) each
    rank of a data row probes another chunk of the group; the new words of
    the group (the lanes still 0 in acc) sum over the db group, a k-mer's
    bin lying in one chunk at most, and fold into acc, which is the same on
    every rank of the row."""
    if mesh is not None and mesh.n_db > 1:
        part = probe_chunk_core(acc.clone(), planes, bounds, codes, ambig, lengths, k, nt, plain)
        part.masked_fill_(acc != 0, 0)
        return acc.add_(mesh.merge_db(part))
    b, lbw = codes.shape
    lb, w = 16 * lbw, acc.shape[1]
    lo, hi = (int(x) for x in bounds)
    raw = table_layout(planes) == "raw"
    name = "rows_probe_acc" if raw else "chd_probe_acc"  # the kernel the pass launches
    if ambig.shape != (b, lbw // 2) or lbw % 2 or lengths.shape != (b,) or acc.shape[0] != b:
        raise ValueError(
            f"{name}: need [B, LB/16] codes, [B, LB/32] flags, [B] lengths and [B, W] acc, got "
            f"{tuple(codes.shape)}, {tuple(ambig.shape)}, {tuple(lengths.shape)}, {tuple(acc.shape)}"
        )
    if not 1 <= nt <= k <= 31 or not 1 <= w <= lb - k + 1 or not 0 <= lo <= hi:
        raise ValueError(f"{name}: need 1 <= nt <= k <= 31, 1 <= W <= LB - k + 1 and a bin range "
                         f"(k={k}, nt={nt}, LB={lb}, W={w}, bounds={bounds})")
    if plain or codes.device.type == "cpu":
        hashes, _, kmer_ambig = kmer_front_packed(codes, ambig, lb, k, 0)  # the encodings go unused
        bins = kmer_bins_plain(_unpack_codes(codes), k, nt)[1][:, :w]
        pos = torch.arange(w, dtype=torch.int32, device=codes.device)[None, :]
        search = (pos < torch.clamp(lengths - (k - 1), min=0)[:, None]) & ~kmer_ambig[:, :w]
        search &= (bins >= lo) & (bins < hi)
        return hash_lookup_acc_plain(planes, hashes[:, :w], search, acc)
    if table_layout(planes) == "fused":
        raise ValueError("chd_probe_acc: chunk tables are CHD (disp4, rows) or raw (ptags, confirm) planes")
    widths = (_raw_width(*planes),) if raw else _chd_widths(*planes)
    dev = _kernels.check_cuda(name, codes=codes, ambig=ambig, lengths=lengths, table0=planes[0],
                              table1=planes[1], acc=acc)
    if any(t.dtype != torch.int32 for t in (codes, ambig, lengths, acc, *planes)):
        raise TypeError(f"{name}: the words, lengths, acc and table planes must be int32")
    # the kernels load 16-byte rows, or a raw table's 8-byte tag and confirm rows
    if not 4 <= widths[0] <= 30 or (any(p.data_ptr() % 8 for p in planes) if raw else planes[1].data_ptr() % 16):
        raise ValueError(f"{name}: the row planes must be aligned to their rows, of width 2^4 to 2^30")
    _kernels.launch(name, dev, codes, ambig, lengths, *planes, acc, b, lb, w, k, nt, lo, hi, *widths)
    return acc


def classify_step_core(
    db_planes,  # per database, in hierarchy order: the table planes ((disp4, rows) or
    # (fused,)); lookup_mode "bsearch": (keys, vals, vals_dense, offsets,
    # bin_start); lookup_mode "acc": the int32 [B, W] merged word plane
    taxid_table: torch.Tensor,  # int32 [T]: device id -> original taxid (uint32 bits)
    io: torch.Tensor,  # int32 [T, 2]: Euler (tin, tout) per id
    parent: torch.Tensor,
    root_dense: int,
    codes: torch.Tensor,  # uint8 [B, LB], or int32 [B, LB/16] words (packed_input)
    ambig: torch.Tensor,  # bool [B, LB], or int32 [B, LB/32] words (packed_input)
    lengths: torch.Tensor,  # int32 [B]
    cfg: StepConfig,
    plain: bool = False,
    mesh=None,
):
    """One classify step. `plain=True` runs the plain PyTorch version of
    every kernel on any device, for holding the kernels against it.

    `mesh` (parallel/mesh.Mesh): the batch is this rank's rows and
    db_planes its db shard of each database. Each database's words sum over
    the db group before the lanes it found are taken (JAX device_step.py:
    185-190, 204-206), so the first-database-wins rule sees merged words;
    a span dictionary merges over the data group (JAX device_step.py:
    316-335). The outputs are this rank's rows."""
    merge = mesh.merge_db if mesh is not None and mesh.n_db > 1 else None
    k = cfg.k
    lookup = hash_lookup_plain if plain else hash_lookup_kmers
    hashes, enc, kmer_ambig, kmers, b, lb = _front(codes, ambig, cfg, plain)
    w = lb - k + 1

    pos = torch.arange(w, dtype=torch.int32, device=codes.device)[None, :]
    n_kmers = torch.clamp(lengths - (k - 1), min=0)[:, None]  # 0 if read shorter than k
    valid = pos < n_kmers

    search = valid & ~kmer_ambig
    # bsearch: the stored taxids (uint32 bits), which the "taxa" plane
    # returns as they are; so do raw (UID) databases' words, which no id
    # table maps. The other modes map taxon_dense through taxid_table
    any_raw = any(cfg.raw_dbs)
    if any_raw and (cfg.quick or tuple(cfg.raw_dbs) != (True,)):
        raise ValueError("a raw (UID) database is searched alone and never in quick mode")
    taxon = None
    if cfg.lookup_mode == "acc":
        # out-of-core finish: the merged word plane, already masked to the
        # searched lanes at probe time (re-masking is a no-op)
        word = torch.where(search, db_planes, 0)
        if any_raw:
            taxon, taxon_dense = word, torch.zeros_like(word)
        else:
            taxon_dense = word
        found = word != 0
        db_planes = ()
    elif cfg.lookup_mode == "bsearch" and cfg.packed_input:
        # one pass a database from the span's words, each writing only the
        # lanes still 0 in taxon: a hit is keyed on the stored taxid, as the
        # JAX package's bsearch branch keys it (a value whose taxon is
        # missing from the taxonomy, dense id 0, is still a hit), so a lane
        # is found iff its taxon is nonzero and the first database's hit wins
        for plane in db_planes:
            if merge is None:
                taxon, taxon_dense = bsearch_words(plane, codes, ambig, lengths, k, cfg.nt, cfg.n_iter, taxon,
                                                   None if taxon is None else taxon_dense, plain=plain)
                continue
            # a shard's words merge before they fill the lanes still 0
            t_i, td_i = bsearch_words(plane, codes, ambig, lengths, k, cfg.nt, cfg.n_iter, plain=plain)
            t_i, td_i = merge(t_i), merge(td_i)
            if taxon is None:
                taxon, taxon_dense = t_i, td_i
            else:
                rem = taxon == 0
                taxon, taxon_dense = torch.where(rem, t_i, taxon), torch.where(rem, td_i, taxon_dense)
        if taxon is None:  # no database
            taxon = taxon_dense = torch.zeros((b, w), dtype=torch.int32, device=codes.device)
        found = taxon != 0
        db_planes = ()
    else:
        taxon_dense = torch.zeros((b, w), dtype=torch.int32, device=codes.device)
        found = torch.zeros((b, w), dtype=torch.bool, device=codes.device)
        if any_raw:
            taxon = torch.zeros_like(taxon_dense)
        if cfg.lookup_mode == "bsearch":
            canon, bins = (kmer_bins_plain if plain else kmer_bins)(codes, cfg.k, cfg.nt)
            taxon = torch.zeros((b, w), dtype=torch.int32, device=codes.device)
            search_fn = lookup_kmers_plain if plain else lookup_kmers
        elif cfg.lookup_mode != "hash":
            raise ValueError(f"lookup_mode must be 'hash', 'bsearch' or 'acc', got {cfg.lookup_mode!r}")
    # hierarchical multi-DB: later DBs only fill lanes still unclassified
    # (classify.cpp:927-936)
    for plane in db_planes:
        remaining = search & ~found
        if cfg.lookup_mode == "bsearch":
            keys, vals, vals_dense, offsets, bin_start = plane
            t_i, td_i = search_fn(keys, vals, vals_dense, offsets, canon, bins, remaining, cfg.n_iter,
                                  bin_start)
            if merge is not None:
                t_i, td_i = merge(t_i), merge(td_i)
            taxon = torch.where(remaining, t_i, taxon)
            taxon_dense = torch.where(remaining, td_i, taxon_dense)
            # keyed on the stored taxid, as above
            found = found | (t_i != 0)
            continue
        word = lookup(plane, hashes, remaining)
        if merge is not None:
            word = merge(word)
        if any_raw:
            taxon = torch.where(remaining, word, taxon)
        else:
            taxon_dense = torch.where(remaining, word, taxon_dense)
        found = found | (word != 0)
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
        if cfg.resolve:
            call_dense = resolve_reads(
                taxon_dense, hit & processed, io, parent, root_dense, cfg.max_depth,
                plain=plain,
            )
        else:
            call_dense = torch.zeros(b, dtype=torch.int32, device=codes.device)
    call = taxid_table[call_dense.long()]

    out = {
        "taxa_dense": taxon_dense,
        "ambig": kmer_ambig,
        "enc": enc,
        "call": call,
        "call_dense": call_dense,
        "hits": total_hits,
        "n_kmers": n_kmers[:, 0],
    }
    asked = lambda key: cfg.outputs is None or key in cfg.outputs
    if asked("processed"):
        out["processed"] = processed
    if cfg.with_kmers and asked("canon"):
        out["canon"] = kmers
    # HLL: every processed non-ambiguous k-mer is counted, including misses
    # under taxon 0 (classify.cpp:939)
    hll_lanes = processed & ~kmer_ambig if asked("hll_lanes") or asked("hll_pairs") else None
    if asked("hll_lanes"):
        out["hll_lanes"] = hll_lanes
    if asked("taxa"):
        # stored values are device ids; original taxids for the hit-list
        # planes (taxid_table[0] == 0, so misses map to 0). A full-plane
        # gather: the span route leaves it out and maps rows on the host.
        # bsearch returns the stored taxids as the search found them, a raw
        # table its words
        out["taxa"] = taxid_table[taxon_dense.long()] if taxon is None else taxon
    if cfg.max_runs > 0 and cfg.dense_runs:
        if asked("packed") or asked("hll_dense") or asked("lut"):
            # runs group on dense ids (injective, so the boundaries equal the
            # original ids'), or on the span dictionary's local ids (injective
            # on the span); the compact layout carries the dense (local) call,
            # the quick one the original call. The same pass emits the host's
            # HLL feed when asked, 6 B per lane with the encoding: a u16 id on
            # the counted lanes, 0xFFFF elsewhere. The processed lanes are a
            # prefix of each read (quick mode's hits_before never falls), so the
            # feed takes their count: n_kmers, or the quick cut.
            layout = "dense" if cfg.quick else "compact"
            ids, row_call = taxon_dense, call if cfg.quick else call_dense
            if cfg.local_dict:
                dictf = span_dict_plain if plain else span_dict
                out["lut"], ids, local_call = dictf(
                    taxon_dense, call_dense, taxid_table.shape[0], cfg.dict_capacity, not cfg.quick
                )
                if mesh is not None and mesh.n_data > 1:
                    # one dictionary for every data slice: this slice's local
                    # ids map to their place in the merged one
                    cap = cfg.dict_capacity
                    merged, n_u = mesh.merge_dict(out["lut"], cap)
                    to_merged = torch.searchsorted(merged, out["lut"][:cap]).clamp_(max=cap - 1).to(torch.int32)
                    ids = to_merged[ids.long()]
                    if local_call is not None:
                        local_call = to_merged[local_call.long()]
                    out["lut"] = torch.cat([merged, n_u.reshape(1)])
                if not cfg.quick:
                    row_call = local_call
            hll16 = asked("hll_dense")
            hll_stop = processed.sum(dim=1, dtype=torch.int32) if cfg.quick and hll16 else None
            rows = (pack_runs_plain if plain else pack_runs)(
                ids, kmer_ambig, n_kmers[:, 0], row_call, total_hits, cfg.max_runs, layout,
                hll16=hll16, hll_stop=hll_stop,
            )
            if hll16:
                out["packed"], out["hll_dense"] = rows
            else:
                out["packed"] = rows
            out["hll_enc"] = enc
    elif cfg.max_runs > 0:
        # the wide rows: runs of dense ids, each run's value mapped to its
        # taxid through taxid_table at [B, R]; the u64 feed carries dense
        # ids. Under a raw (UID) database the runs and the feed carry the
        # raw words as they are (no id table maps a taxon-set id)
        ids = taxon if any_raw else taxon_dense
        if asked("packed"):
            out["packed"] = (pack_runs_plain if plain else pack_runs)(
                ids, kmer_ambig, n_kmers[:, 0], call, total_hits, cfg.max_runs, "wide",
                None if any_raw else taxid_table,
            )
        if asked("hll_pairs"):
            out["hll_pairs"] = hll_pairs_feed(ids, enc, hll_lanes)
    if cfg.outputs is not None:
        out = {key: out[key] for key in cfg.outputs}
    return out


def classify_and_count_core(
    reg: torch.Tensor,  # uint8 [P, m] register pool (updated in place)
    kmer_counts: torch.Tensor,  # int64 [T] (updated in place)
    read_counts: torch.Tensor,  # int64 [T] (updated in place)
    lut: torch.Tensor | None,  # int32 [T] id -> register row; None: rows are ids
    db_planes,
    taxid_table: torch.Tensor,
    io: torch.Tensor,
    parent: torch.Tensor,
    root_dense: int,
    codes: torch.Tensor,
    ambig: torch.Tensor,
    lengths: torch.Tensor,
    n_valid: int,  # rows [0, n_valid) hold reads (their calls are counted)
    unit_id: torch.Tensor | None,  # integer [B]: work-unit index per row (< 64)
    cfg: StepConfig,
    p: int,
    sparse_cap: int = 0,
    counts_only: bool = False,
    plain: bool = False,
):
    """The step with the --device-counters update after it on the same
    stream, after the JAX package's _classify_and_count_core
    (krakenuniq_tpu/classify/device_step.py:538-603): the step returns the
    planes the update reads (taxa_dense, enc, hll_lanes, call_dense) besides
    cfg.outputs, `update_core` folds them into the state in place, and only
    cfg.outputs return, with the sparse-stats buffer (buf, n_pairs,
    n_events; () when not tracked). Nothing waits for the card. The update
    keys on the global dense ids, under a span dictionary too; under a raw
    (UID) database on the raw words (the "taxa" plane: the reference counts
    k-mers under the stored UID, classify.cpp:939)."""
    from .device_counters import update_core

    id_key = "taxa" if any(cfg.raw_dbs) else "taxa_dense"
    counted = (id_key, "enc", "hll_lanes", "call_dense")
    outputs = None if cfg.outputs is None else (
        tuple(cfg.outputs) + tuple(k for k in counted if k not in cfg.outputs)
    )
    out = classify_step_core(
        db_planes, taxid_table, io, parent, root_dense, codes, ambig, lengths,
        dataclasses.replace(cfg, outputs=outputs), plain=plain,
    )
    b = out["call_dense"].shape[0]
    row_valid = torch.arange(b, device=out["call_dense"].device) < n_valid
    state = update_core(
        reg, kmer_counts, read_counts, lut, out[id_key], out["enc"], out["hll_lanes"],
        out["call_dense"], row_valid, p, unit_id, sparse_cap, counts_only, plain=plain,
    )
    if cfg.outputs is not None:
        out = {key: out[key] for key in cfg.outputs}
    return out, state[3:]
