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
as exactly. Plane construction runs in numpy, and so does the self-check
probe, unless the caller checks on a card through the table's own kernel
(db/device_db.py); the planes go to the device once validated.

The two-choice FUSED layout is the build's fallback when CHD placement
fails at every width: one u32 [2^lb, 4] plane of [tag0, val0, tag1, val1]
rows. Every key has two candidate buckets
    b1 = h >> (64 - lb)        b2 = (h * GOLDEN) >> (64 - lb)
and is stored under the probe value hc of the choice that placed it (h for
b1, h * GOLDEN for b2; both maps are bijections) as
  tag  = bits [lb, lb+32) of hc
  val  = choice << 31 | spare << (lb - 1) | value,  spare = the low 32 - lb bits of hc,
so an accepted slot pins all 64 bits of hc, hence h: exact as well.
Placement is a vectorized two-choice cuckoo walk in numpy (`_host_place`);
keys whose first-choice tag is 0 are pinned to b1, where occupants sit
ahead of the all-zero empty slots that could otherwise shadow them. The
value must fit lb - 1 bits (`min_lb_for`).

Raw-valued (UID) tables (`store_raw`) store the raw 32-bit database value,
which leaves no spare bits in the value word, in the TWO-LEVEL layout over
the same cuckoo placement:
  ptags:   uint32 [2^lb, 2]         a tag per slot: bits [lb, lb+32) of hc
  confirm: uint32 [2^(lb+1), 2]     per slot (low 32 bits of h, value)
24 B a bucket. The probe screens both buckets' tags, takes the first
screened slot (slot 0 before slot 1, b1 before b2; b2 only where b2 != b1)
and accepts it when its confirm word holds h's low 32 bits: tag and confirm
pin 64 bits of hc and h together, so a false accept needs a 2^-(64+lb)
coincidence (krakenuniq_tpu/db/hash_table.py).
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.bits import murmur3_finalizer

BUCKET_SLOTS = 2
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


def bucket_ids(h, lb: int):
    """The fused layout's two candidate bucket ids of uint64 hashes."""
    shift = np.uint64(64 - lb)
    return (h >> shift).astype(np.int64), ((h * GOLDEN) >> shift).astype(np.int64)


def partial_tags(h, lb: int):
    """Bits [lb, lb+32) of the probe value: the tag for a bucket derived
    from h's top lb bits."""
    return ((h << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)


class HashBuildError(RuntimeError):
    """Placement (or the exactness self-check) failed at every attempted
    table size. Callers fall back: `build_hash_table(layout="auto")` to the
    fused layout, `build_device_db` to the binary-search planes."""


def _host_place(hashes: np.ndarray, lb: int, max_rounds: int = 400, seed: int = 0):
    """Two-choice cuckoo placement with eviction, vectorized over the whole
    unplaced ("active") set per round.

    Each round, every active key picks a wanted slot in its target bucket
    (first empty slot, else a coin-chosen victim), claims it with a
    minimum-index scatter (np.minimum.at), and winners displace any victim
    into the active set with the OTHER of its two buckets as the new target.
    The active set shrinks geometrically; keys whose first-choice tag is 0
    are pinned to bucket b1 (a superset of the empty-row shadow pattern the
    fused layout needs pinned -- see module docstring).

    Returns int32 assigned-bucket-per-key, or None if placement failed
    (caller grows the table)."""
    n = len(hashes)
    nb = 1 << lb
    shift = np.uint64(64 - lb)
    b1 = (hashes >> shift).astype(np.int64)
    b2 = ((hashes * GOLDEN) >> shift).astype(np.int64)
    pinned = ((hashes << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32) == 0
    b2 = np.where(pinned, b1, b2)
    # slot indices fit int32 through lb=29 (2*nb <= 2^30): half the memory
    # traffic of the per-round gathers/wheres at 10^8-key scale
    idx_t = np.int64 if (lb >= 30 or n >= (1 << 31) - 2) else np.int32
    b1 = b1.astype(idx_t, copy=False)
    b2 = b2.astype(idx_t, copy=False)

    slots = np.full(nb * BUCKET_SLOTS, -1, dtype=np.int32)  # occupant key index
    active = np.arange(n, dtype=np.int32)
    target = b1.copy()  # bucket each active key tries this round
    claim = np.full(nb * BUCKET_SLOTS, n, dtype=np.int32)  # reset per round below
    for rnd in range(max_rounds):
        if rnd == 0:
            # every slot is empty: want = first slot of the first choice
            t = b1
            want = t * 2
        else:
            t = target[active]
            s0 = slots[t * 2]
            s1 = slots[t * 2 + 1]
            want = np.where(s0 < 0, t * 2, t * 2 + 1)
            # the eviction coin (a u64 shift over the hashes) is only needed
            # where BOTH slots are full -- a small subset after round 1
            both = (s0 >= 0) & (s1 >= 0)
            if both.any():
                sub = np.flatnonzero(both)
                coin = (
                    (hashes[active[sub]] >> np.uint64((rnd + seed) % 61))
                    & np.uint64(1)
                ).astype(idx_t)
                want[sub] = t[sub] * 2 + coin
        # claim-verify: lowest key index wins a contested slot
        np.minimum.at(claim, want, active)
        win = claim[want] == active
        claim[want] = n  # restore only the touched entries for the next round
        won_slots = want[win]
        victims = slots[won_slots]
        slots[won_slots] = active[win]
        evicted = victims[victims >= 0]
        if len(evicted):
            # a victim's next target is its OTHER bucket (random-walk cuckoo)
            from_bucket = won_slots[victims >= 0] // 2
            other = np.where(b1[evicted] == from_bucket, b2[evicted], b1[evicted])
            target[evicted] = other
        active = np.concatenate([active[~win], evicted])
        if len(active) == 0:
            assign = np.empty(n, dtype=np.int32)
            occ = slots >= 0
            assign[slots[occ]] = (np.nonzero(occ)[0] // 2).astype(np.int32)
            return assign
        # losers retry the same bucket next round with a fresh coin; if both
        # of a key's buckets stay full, eviction chains open space over a few
        # rounds -- stagnation past max_rounds means the load is too high
    return None


def _slot_layout(assign, hashes, lb: int):
    """Each key's flat slot index and the probe value hc of the choice that
    placed it (h in its first bucket, h * GOLDEN in its second), in key
    order. A bucket's keys take its slots in key order (the lowest index
    slot 0; _host_place leaves at most two keys a bucket), as the JAX
    package's stable argsort by bucket lays them out; the lowest index per
    bucket comes from one minimum scatter instead of the sort."""
    n = len(assign)
    idx = np.arange(n, dtype=np.int64 if n >= (1 << 31) - 1 else np.int32)
    first = np.full(1 << lb, n, dtype=idx.dtype)
    np.minimum.at(first, assign, idx)
    rows = assign.astype(np.int64)
    flat_idx = rows * BUCKET_SLOTS + (first[assign] != idx)
    second = rows != (hashes >> np.uint64(64 - lb)).astype(np.int64)
    hc = np.where(second, hashes * GOLDEN, hashes)
    return flat_idx, hc, second


def _host_planes_fused(assign, hashes, values, lb: int):
    """Host numpy construction of the fused plane (see module docstring)."""
    nb = 1 << lb
    v_bits = lb - 1
    flat_idx, hc, second = _slot_layout(assign, hashes, lb)
    v_s = values.astype(np.uint32)
    if len(v_s) and int(v_s.max()) >> v_bits:
        raise ValueError(
            f"value {int(v_s.max())} does not fit the {v_bits}-bit taxon field"
        )
    tag_s = ((hc << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)
    spare = (hc & np.uint64((1 << (32 - lb)) - 1)).astype(np.uint32)
    word = (
        (second.astype(np.uint32) << np.uint32(31))
        | (spare << np.uint32(v_bits))
        | v_s
    )
    fused = np.zeros((nb * BUCKET_SLOTS, 2), np.uint32)
    fused[flat_idx, 0] = tag_s
    fused[flat_idx, 1] = word
    return fused.reshape(nb, BUCKET_SLOTS * 2)


def _host_planes_two(assign, hashes, values, lb: int):
    """Host numpy construction of the two-level (ptags, confirm) planes of
    raw-valued (UID) tables (module docstring)."""
    nb = 1 << lb
    flat_idx, hc, _second = _slot_layout(assign, hashes, lb)
    ptags = np.zeros(nb * BUCKET_SLOTS, np.uint32)
    ptags[flat_idx] = ((hc << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)
    confirm = np.zeros((nb * BUCKET_SLOTS, 2), np.uint32)
    confirm[flat_idx, 0] = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    confirm[flat_idx, 1] = values
    return ptags.reshape(nb, BUCKET_SLOTS), confirm


def _self_check(host_planes, hashes, values, lb: int) -> int:
    """Probe every key through a numpy mirror of the device probe; returns
    the number of mismatching keys. `host_planes` = (disp4, rows) of the CHD
    layout (lb is its row bits lr), (fused,) or (ptags, confirm)."""
    n_bad = 0
    shift = np.uint64(64 - lb)
    for s in range(0, len(hashes), _SELF_CHECK_CHUNK):
        h = hashes[s : s + _SELF_CHECK_CHUNK]
        want = values[s : s + _SELF_CHECK_CHUNK]
        if len(host_planes) == 2 and host_planes[0].shape[1] == 4:
            disp4, rows_plane = host_planes
            lr = lb
            lg = int(np.log2(disp4.shape[0] * 4))
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
        elif len(host_planes) == 1:
            fused = host_planes[0]
            v_bits = lb - 1
            tax_mask = np.uint32((1 << v_bits) - 1)
            hi_mask = ~tax_mask
            spare_mask = np.uint64((1 << (32 - lb)) - 1)
            got = np.zeros(len(h), np.uint32)
            found = np.zeros(len(h), bool)
            for hc, choice in ((h, 0), (h * GOLDEN, 1)):
                r = (hc >> shift).astype(np.int64)
                tag = ((hc << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)
                hi = (hc & spare_mask).astype(np.uint32) << np.uint32(v_bits)
                if choice:
                    hi |= np.uint32(1 << 31)
                rows = fused[r]  # [n, 4]
                for slot in (0, 1):
                    m = (rows[:, 2 * slot] == tag) & (
                        (rows[:, 2 * slot + 1] & hi_mask) == hi
                    )
                    got = np.where(m & ~found, rows[:, 2 * slot + 1] & tax_mask, got)
                    found |= m
        else:
            # two-level: the first screened slot, then its confirm word
            ptags, confirm = host_planes
            hg = h * GOLDEN
            r1 = (h >> shift).astype(np.int64)
            r2 = (hg >> shift).astype(np.int64)
            eq1 = ptags[r1] == partial_tags(h, lb)[:, None]
            eq2 = (ptags[r2] == partial_tags(hg, lb)[:, None]) & (r1 != r2)[:, None]
            has1 = eq1.any(axis=1)
            flat = np.where(has1, r1 * BUCKET_SLOTS + np.argmax(eq1, axis=1),
                            r2 * BUCKET_SLOTS + np.argmax(eq2, axis=1))
            crow = confirm[flat]
            ok = (has1 | eq2.any(axis=1)) & (crow[:, 0] == (h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            got = np.where(ok, crow[:, 1], np.uint32(0))
        n_bad += int(np.count_nonzero(got != want))
    return n_bad


def min_lb_for(n_keys: int, max_value: int, load_factor: float = 0.6) -> int:
    """Smallest bucket-bits satisfying both the load factor and the fused
    layout's taxon-field width (max_value < 2^(lb-1))."""
    lb = max(4, int(np.ceil(np.log2(max(n_keys, 2) / (BUCKET_SLOTS * load_factor)))))
    return max(lb, int(max_value).bit_length() + 1)


def build_hash_table(keys: np.ndarray, values: np.ndarray, self_check: bool = True,
                     timings: dict | None = None, force_lr: int | None = None,
                     layout: str = "auto", store_raw: bool = False, check=None):
    """Build the table planes for `keys` (uint64 k-mers) -> `values` (pool
    or dense ids), after the JAX package's build_hash_table. Returns
    (host_planes, lb): ((disp4 uint32 [2^(lr-2), 4], rows uint32 [2^lr, 4]),
    lr) for the CHD layout, ((fused uint32 [2^lb, 4],), lb) for the fused
    one, ((ptags uint32 [2^lb, 2], confirm uint32 [2^(lb+1), 2]), lb) for
    the two-level one of `store_raw`.

    `store_raw` (UID databases): `values` are raw 32-bit database values,
    which only the two-level layout holds; CHD is skipped whatever
    `layout` says, and the width is the load factor's alone (0.6).
    `layout`: "auto" tries CHD and falls back to the fused layout when CHD
    placement fails at every width; "chd" and "fused" pin the layout (the
    out-of-core chunk tables pin "chd"). CHD placement is retried with
    three seeds per width, then the table grows, up to 2^30 rows; fused
    placement likewise from `min_lb_for` (load 0.6) up to 2^30 buckets.
    `force_lr` pins the width of either layout: only the seed retries apply.
    Every success is self-checked key by key (`check(host_planes, hashes,
    values, width)` -> the keys that do not probe back to their value; the
    numpy mirror `_self_check` by default, the table's kernel on the card
    for a card's load: db/device_db.py); every failure raises
    HashBuildError. `timings`, if given, receives the seconds of each step
    ("hash", "place", "planes", "check"), summed over retries and layouts."""
    if layout not in ("auto", "chd", "fused"):
        raise ValueError(f"layout must be 'auto', 'chd' or 'fused', got {layout!r}")
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
    lap("hash")

    def checked(host, width):
        lap("planes")
        ok = not self_check or n == 0 or (check or _self_check)(host, hashes, values, width) == 0
        lap("check")
        return ok

    if layout in ("auto", "chd") and not store_raw:
        lr = chd_min_lr(n, vmax) if force_lr is None else force_lr
        if force_lr is not None and vmax >> lr:
            raise ValueError(f"force_lr={lr} cannot hold value {vmax} in {lr} bits (CHD)")
        lr_max = 30 if force_lr is None else min(force_lr, 30)
        while lr <= lr_max:
            for seed in range(3):
                out = _chd_place(hashes, lr, max(2, lr - 2), seed=seed)
                lap("place")
                if out is None:
                    continue
                row_of, col_of, disp = out
                host = _host_planes_chd(row_of, col_of, hashes, values, lr, disp)
                if checked(host, lr):
                    return host, lr
            lr += 1
        if layout == "chd":
            raise HashBuildError(
                f"CHD placement failed for {n} keys up to 2^{lr_max} rows"
                + (f" (force_lr={force_lr})" if force_lr is not None else "")
            )
        # layout == "auto": fall through to the fused two-choice build
    if force_lr is not None:
        lb = lb_max = force_lr
        if not store_raw and vmax >> (lb - 1):
            raise ValueError(f"force_lr={lb} cannot hold value {vmax} in {lb - 1} bits")
    elif store_raw:
        lb, lb_max = max(4, int(np.ceil(np.log2(max(n, 2) / (BUCKET_SLOTS * 0.6))))), 30
    else:
        lb, lb_max = min_lb_for(n, vmax), 30
    if lb > 30:
        raise HashBuildError(f"hash table of 2^{lb} buckets is not supported ({n} keys)")
    while lb <= lb_max:
        for seed in range(3):  # fresh eviction-coin walks before growing
            assign = _host_place(hashes, lb, seed=seed * 17)
            lap("place")
            if assign is None:
                continue
            host = (_host_planes_two(assign, hashes, values, lb) if store_raw
                    else (_host_planes_fused(assign, hashes, values, lb),))
            if checked(host, lb):
                return host, lb
        lb += 1
    raise HashBuildError(
        f"hash table placement failed for {n} keys up to 2^{lb - 1} buckets"
        + (f" (force_lr={force_lr})" if force_lr is not None else "")
    )
