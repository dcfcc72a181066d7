"""Host construction of the CHD (compressed hash-and-displace) k-mer table.

The layout and its exactness argument are krakenuniq_tpu/db/hash_table.py's:

  disp: uint32 [2^(lg-2), 4]   one u32 displacement word per bucket,
                               packed 4 per row; bucket g holds
                               (d1 << 16) | d0
  rows: uint32 [2^lr, 4]       2 slots of 8B each: slot = (r << lr) | v
                               stored as [hi32, lo32]

A key's murmur hash h splits into p = top lr bits and r = low 64-lr bits;
bucket g = top lg bits of r*GOLDEN, q = top lr bits of r*C2, and the key
lives in row (p + d0 + d1*q) mod 2^lr. A slot stores r next to the value and
the row pins p, so a match pins all 64 bits of h: the lookup is exact. Empty
slots are all-zero and "match" only r == 0 queries, yielding value 0 = miss.

Placement runs on the host in the port's native module (`_chd_place`,
kuniq_native_torch.chd_place: a sequential largest-bucket-first search);
`_chd_place_numpy` is its plain numpy version, which places differently but
as exactly. Plane construction and the self-check probe run in numpy; the
planes go to the device once validated (db/device_db.py). The JAX package's fused two-choice and
two-level layouts are a later slice of the port: a failed CHD build raises
HashBuildError instead of falling back.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.bits import murmur3_finalizer

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
C2 = np.uint64(0xC2B2AE3D27D4EB4F)  # q-mix multiplier (odd => bijective)
CHD_MAX_LOAD = 0.85  # keys / (2 * 2^lr); power-of-two snap => load > 0.42
_SELF_CHECK_CHUNK = 1 << 21


def chd_min_lr(n_keys: int, max_value: int, load_factor: float = CHD_MAX_LOAD) -> int:
    """Smallest row-bits lr for the CHD layout: capacity (2 slots/row at
    <= load_factor) and value width (value fits lr bits) both bind; the
    remainder always fits the other 64-lr slot bits, so there is no lower
    bound from exactness."""
    lr = max(4, int(np.ceil(np.log2(max(n_keys, 2) / (2 * load_factor)))))
    return max(lr, int(max_value).bit_length())


def chd_table_bytes(lr: int) -> int:
    """Device bytes of a CHD table at row-bits lr (rows plane + disp plane)."""
    return (1 << lr) * 16 + (1 << max(2, lr - 2)) * 4


def _chd_split(hashes, lr: int, lg: int):
    """Per-key addressing fields (shared by build, self-check, and the
    device probe's host mirror)."""
    r_mask = np.uint64((1 << (64 - lr)) - 1)
    p = (hashes >> np.uint64(64 - lr)).astype(np.uint32)
    r = hashes & r_mask
    g = ((r * GOLDEN) >> np.uint64(64 - lg)).astype(np.int64)
    q = ((r * C2) >> np.uint64(64 - lr)).astype(np.uint32)
    return p, r, g, q


def _chd_place_numpy(hashes, lr: int, lg: int, seed: int = 0, max_attempts: int = 65536):
    """Vectorized fallback placement when the native extension is absent:
    largest-first tiers, per-round candidate windows screened against a
    packed free-slot bitmap, priority claims (lowest bucket rank wins a
    contested row; contention losers retry the same window). ~5-8x slower
    than the sequential first-success search in native chd_place."""
    n = len(hashes)
    nrows = 1 << lr
    p, _r, g, q = _chd_split(hashes, lr, lg)
    order = np.argsort(g, kind="stable")
    ug, bstart, bcount = np.unique(g[order], return_index=True, return_counts=True)
    occ = np.zeros(nrows, np.uint8)
    free_bits = np.full(max(1, nrows >> 3), 0xFF, np.uint8)
    disp = np.zeros(1 << lg, np.uint32)
    row_of = np.full(n, -1, np.int32)
    col_of = np.zeros(n, np.int8)
    rowmask = np.uint32(nrows - 1)
    claim = np.full(nrows, 2**31 - 1, np.int32)
    for size in np.sort(np.unique(bcount))[::-1]:
        sel = bcount == size
        tb_g = ug[sel]
        kidx = order[bstart[sel][:, None] + np.arange(size)[None, :]]
        pp = p[kidx].astype(np.uint32)
        qq = q[kidx].astype(np.uint32)
        act = np.arange(len(tb_g))
        attempt = np.zeros(len(tb_g), np.int64)
        A = 2
        while len(act):
            na = len(act)
            t = attempt[act].astype(np.uint64)
            gb = tb_g[act].astype(np.uint64)
            dmix = murmur3_finalizer(
                (gb[:, None] << np.uint64(24))
                + (t[:, None] + np.arange(A, dtype=np.uint64)[None, :])
                + np.uint64(seed) * np.uint64(0x9E3779B9)
            )
            d0 = (dmix & np.uint64(0xFFFF)).astype(np.uint32)
            d1 = ((dmix >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.uint32)
            rows = (
                pp[act][:, None, :]
                + d0[:, :, None]
                + d1[:, :, None] * qq[act][:, None, :]
            ) & rowmask
            rowsl = rows.astype(np.int32)
            fb = (free_bits[rowsl >> 3] >> (rowsl & 7).astype(np.uint8)) & 1
            cand_ok = fb.all(axis=2) if size > 1 else fb[..., 0].astype(bool)
            has = cand_ok.any(axis=1)
            choice = np.argmax(cand_ok, axis=1)
            ch_rows = np.take_along_axis(rowsl, choice[:, None, None], axis=1)[:, 0, :]
            ch_d0 = np.take_along_axis(d0, choice[:, None], axis=1)[:, 0]
            ch_d1 = np.take_along_axis(d1, choice[:, None], axis=1)[:, 0]
            if size >= 2:
                # exact within-candidate demand on the chosen rows only
                rs = np.sort(ch_rows, axis=1)
                eq = rs[:, 1:] == rs[:, :-1]
                bad = ((occ[rs[:, 1:]] + 2 > 2) & eq).any(axis=1)
                if size >= 3:
                    bad |= (eq[:, 1:] & eq[:, :-1]).any(axis=1)
                bad &= has
                if bad.any():
                    attempt[act[bad]] += choice[bad] + 1
                    has = has & ~bad
            pri = np.arange(na, dtype=np.int32)
            fr = ch_rows[has]
            np.minimum.at(claim, fr.ravel(), np.repeat(pri[has], size))
            okb = np.zeros(na, bool)
            okb[has] = (claim[fr] == pri[has, None]).all(axis=1)
            claim[fr.ravel()] = 2**31 - 1
            w_idx = act[okb]
            if len(w_idx):
                # columns assigned GLOBALLY per round: different buckets may
                # jointly win slots of one row
                wrows = ch_rows[okb].ravel()
                wkeys = kidx[w_idx].ravel()
                o = np.argsort(wrows, kind="stable")
                sr = wrows[o]
                first = np.ones(len(sr), bool)
                first[1:] = sr[1:] != sr[:-1]
                start = np.maximum.accumulate(np.where(first, np.arange(len(sr)), -1))
                rank = (np.arange(len(sr)) - start).astype(np.int8)
                cols = np.empty(len(sr), np.int8)
                cols[o] = occ[sr].astype(np.int8) + rank
                np.add.at(occ, wrows, 1)
                nowfull = wrows[occ[wrows] >= 2]
                np.bitwise_and.at(
                    free_bits,
                    nowfull >> 3,
                    (~(np.uint8(1) << (nowfull & 7).astype(np.uint8))).astype(np.uint8),
                )
                row_of[wkeys] = wrows
                col_of[wkeys] = cols
                disp[tb_g[w_idx]] = (ch_d1[okb] << np.uint32(16)) | ch_d0[okb]
            bump = ~okb & ~has
            attempt[act[bump]] += A
            act = act[~okb]
            if len(act) and int(attempt[act].max()) >= max_attempts:
                return None
            p_obs = max(okb.mean(), 1e-3)
            A = int(min(32, max(2, np.ceil(1.0 / p_obs))))
    return row_of, col_of, disp


def _chd_place(hashes, lr: int, lg: int, seed: int = 0, max_attempts: int = 65536):
    """Returns (row_of int32[n], col_of int8[n], disp uint32[2^lg]) or None,
    from the native placement (built on first use; a failed build raises)."""
    from .._native_build import native

    return native().chd_place(np.ascontiguousarray(hashes, np.uint64), lr, lg, seed, max_attempts)


def _host_planes_chd(row_of, col_of, hashes, values, lr: int, disp):
    """Host numpy construction of the CHD planes (module docstring):
    (disp4 uint32 [2^(lg-2), 4], rows uint32 [2^lr, 4])."""
    nrows = 1 << lr
    r = hashes & np.uint64((1 << (64 - lr)) - 1)
    s = (r << np.uint64(lr)) | values.astype(np.uint64)
    rows = np.zeros((nrows, 4), np.uint32)
    flat = row_of.astype(np.int64)
    c2 = col_of.astype(np.int64) * 2
    rows[flat, c2] = (s >> np.uint64(32)).astype(np.uint32)
    rows[flat, c2 + 1] = (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return disp.reshape(-1, 4), rows



class HashBuildError(RuntimeError):
    """CHD placement (or the exactness self-check) failed at every attempted
    table size."""


def _self_check(host_planes, hashes, values, lr: int) -> int:
    """Probe every key through a numpy mirror of the device probe; returns
    the number of mismatching keys."""
    n_bad = 0
    disp4, rows_plane = host_planes
    lg = int(np.log2(disp4.shape[0] * 4))
    for s in range(0, len(hashes), _SELF_CHECK_CHUNK):
        h = hashes[s : s + _SELF_CHECK_CHUNK]
        want = values[s : s + _SELF_CHECK_CHUNK]
        p, r, g, q = _chd_split(h, lr, lg)
        d = disp4.reshape(-1)[g]
        d0 = d & np.uint32(0xFFFF)
        d1 = d >> np.uint32(16)
        row = (p + d0 + d1 * q) & np.uint32((1 << lr) - 1)
        rw = rows_plane[row.astype(np.int64)]
        v_mask = np.uint32((1 << lr) - 1)
        e_hi = (r >> np.uint64(32 - lr)).astype(np.uint32)
        e_lo = (
            (r & np.uint64((1 << (32 - lr)) - 1)) << np.uint64(lr)
        ).astype(np.uint32)
        m0 = (rw[:, 0] == e_hi) & ((rw[:, 1] & ~v_mask) == e_lo)
        m1 = (rw[:, 2] == e_hi) & ((rw[:, 3] & ~v_mask) == e_lo)
        got = np.maximum(
            np.where(m0, rw[:, 1] & v_mask, 0),
            np.where(m1, rw[:, 3] & v_mask, 0),
        )
        n_bad += int(np.count_nonzero(got != want))
    return n_bad


def build_hash_table(keys: np.ndarray, values: np.ndarray, self_check: bool = True,
                     timings: dict | None = None, force_lr: int | None = None):
    """Build the CHD planes for `keys` (uint64 k-mers) -> `values` (pool or
    dense ids). Returns ((disp4 uint32 [2^(lr-4), 4], rows uint32 [2^lr, 4]),
    lr). Placement is retried with three seeds per width, then the table
    grows, up to 2^30 rows; every success is self-checked key by key.
    `force_lr` pins the width (the out-of-core chunk tables share one): only
    the seed retries apply, and a stall raises HashBuildError. `timings`, if
    given, receives the seconds of each step ("hash", "place", "planes",
    "check"), summed over retries."""
    t = timings if timings is not None else {}
    t.update(hash=0.0, place=0.0, planes=0.0, check=0.0)
    t0 = time.perf_counter()

    def lap(step):
        nonlocal t0
        t1 = time.perf_counter()
        t[step] += t1 - t0
        t0 = t1

    n = len(keys)
    hashes = murmur3_finalizer(np.ascontiguousarray(keys, dtype=np.uint64))
    values = np.asarray(values).astype(np.uint32)
    vmax = int(values.max()) if n else 0
    lr = chd_min_lr(n, vmax) if force_lr is None else force_lr
    if force_lr is not None and vmax >> lr:
        raise ValueError(f"force_lr={lr} cannot hold value {vmax} in {lr} bits (CHD)")
    lr_max = 30 if force_lr is None else min(force_lr, 30)
    lap("hash")
    while lr <= lr_max:
        for seed in range(3):
            out = _chd_place(hashes, lr, max(2, lr - 2), seed=seed)
            lap("place")
            if out is None:
                continue
            row_of, col_of, disp = out
            host = _host_planes_chd(row_of, col_of, hashes, values, lr, disp)
            lap("planes")
            ok = not self_check or n == 0 or _self_check(host, hashes, values, lr) == 0
            lap("check")
            if ok:
                return host, lr
        lr += 1
    if force_lr is not None:
        raise HashBuildError(f"CHD placement failed for {n} keys at the forced width 2^{force_lr}")
    raise HashBuildError(
        f"CHD placement failed for {n} keys up to 2^30 rows; the fused "
        "two-choice fallback layout is not ported yet (a later slice)"
    )
