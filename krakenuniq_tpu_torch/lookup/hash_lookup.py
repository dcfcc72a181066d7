"""Device-side hash-table k-mer lookup: the CHD layout and the fused
two-choice layout of db/hash_table.py.

CHD: a displacement plane `disp4` int32 [2^(lg-2), 4] and a row plane
`rows` int32 [2^lr, 4], both holding uint32 bit patterns. A query is the
murmur hash of its canonical k-mer (int64 holding uint64 bits); the probe
reads one displacement word, then one 16-byte row, and compares both slots
against the query's remainder -- an exact lookup (see
krakenuniq_tpu/lookup/hash_lookup.py and the kernel's note in
csrc/chd_probe.cu).

Fused (the build's fallback layout): one plane int32 [2^lb, 4] of [tag0,
val0, tag1, val1] rows; the probe reads the rows of both candidate buckets
and accepts a slot whose tag and value-word high bits (choice flag and
spare hash bits) both match -- also exact.

Raw two-level (UID databases, whose 32-bit values leave no spare bits):
`ptags` int32 [2^lb, 2], a tag per slot, and `confirm` int32 [2^(lb+1), 2],
per slot (low 32 bits of h, value). The probe takes the FIRST screened slot
(slot 0 before slot 1, the first choice before the second, the second only
where its bucket differs) and then that slot's confirm row: the value where
it holds h's low 32 bits, else 0 (krakenuniq_tpu/lookup/hash_lookup.py,
_probe_rows). The kernel reads the second bucket only where no slot of the
first screens (`probe_rows_rounds` is its algorithm in plain torch).

The layout is told by the plane structure, as the JAX package's `_probe`
tells it: one plane = fused, two planes with `shape[1] == 4` = CHD, two
planes with `shape[1] == 2` = raw.

`hash_lookup_kmers` launches the `chd_probe`, `fused_probe` or `rows_probe`
CUDA kernel on CUDA tensors and runs `probe_chd_plain`, `probe_fused_plain`
or `probe_rows_plain`, the plain PyTorch versions, on CPU tensors.
`hash_lookup_acc_plain` is the plain fold of one chunk table's hits into an
accumulated word plane, the last step of the out-of-core pass's plain
version (classify/device_step.probe_chunk_core, whose kernels are the
`chd_probe_acc` and `rows_probe_acc` entries of the same library).
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..db.hash_table import C2, GOLDEN
from ..ints import i32_to_u32, lsr, s64, u32_to_i32

_GOLDEN = s64(int(GOLDEN))
_C2 = s64(int(C2))


def _chd_widths(disp4: torch.Tensor, rows: torch.Tensor) -> tuple[int, int]:
    """(lr, lg) of a CHD table from its plane shapes."""
    if disp4.dim() != 2 or disp4.shape[1] != 4 or rows.dim() != 2 or rows.shape[1] != 4:
        raise ValueError("chd_probe: need disp4 [2^(lg-2), 4] and rows [2^lr, 4] planes")
    n_disp, n_rows = int(disp4.shape[0]) * 4, int(rows.shape[0])
    if n_disp & (n_disp - 1) or n_rows & (n_rows - 1) or n_rows == 0:
        raise ValueError(
            f"chd_probe: {n_disp} displacement words and {n_rows} rows must be powers of two"
        )
    return n_rows.bit_length() - 1, n_disp.bit_length() - 1


def _fused_width(fused: torch.Tensor) -> int:
    """lb (bucket bits) of a fused table from its plane shape."""
    nb = int(fused.shape[0]) if fused.dim() == 2 else 0
    if fused.dim() != 2 or fused.shape[1] != 4 or nb & (nb - 1) or not 16 <= nb <= 1 << 30:
        raise ValueError("fused_probe: need a [2^lb, 4] plane with 4 <= lb <= 30")
    return nb.bit_length() - 1


def _raw_width(ptags: torch.Tensor, confirm: torch.Tensor) -> int:
    """lb (bucket bits) of a raw two-level table from its plane shapes."""
    nb = int(ptags.shape[0]) if ptags.dim() == 2 else 0
    if (ptags.dim() != 2 or ptags.shape[1] != 2 or nb & (nb - 1) or not 16 <= nb <= 1 << 30
            or tuple(confirm.shape) != (2 * nb, 2)):
        raise ValueError("rows_probe: need ptags [2^lb, 2] and confirm [2^(lb+1), 2] planes, 4 <= lb <= 30")
    return nb.bit_length() - 1


def table_layout(planes) -> str:
    """"fused" for one plane, "chd" for (disp4, rows), "raw" for the
    two-level (ptags, confirm) planes of UID databases."""
    if len(planes) == 1:
        return "fused"
    if len(planes) == 2 and planes[0].dim() == 2 and planes[0].shape[1] in (2, 4):
        return "chd" if planes[0].shape[1] == 4 else "raw"
    raise ValueError(f"no table layout has planes of shapes {[tuple(p.shape) for p in planes]}")


def probe_rows_plain(ptags, confirm, h, lb: int):
    """Plain PyTorch two-level probe (krakenuniq_tpu.lookup.hash_lookup.
    _probe_rows): returns (found bool [n], value int64 [n]) for int64 query
    hashes `h`. Only the first screened slot is confirmed."""
    hg = h * _GOLDEN
    r1, r2 = lsr(h, 64 - lb), lsr(hg, 64 - lb)
    eq1 = i32_to_u32(ptags[r1]) == lsr(h << lb, 32)[:, None]
    # when both choices land on one bucket, its keys carry first-choice tags
    eq2 = (i32_to_u32(ptags[r2]) == lsr(hg << lb, 32)[:, None]) & (r1 != r2)[:, None]
    has1 = eq1.any(dim=1)
    flat = torch.where(has1, 2 * r1 + (~eq1[:, 0]).long(), 2 * r2 + (~eq2[:, 0]).long())
    crow = i32_to_u32(confirm[flat])
    ok = (has1 | eq2.any(dim=1)) & (crow[:, 0] == (h & 0xFFFFFFFF))
    return ok, crow[:, 1]


def _raw_bucket(ptags, confirm, b, hc, h, lb: int):
    """A raw bucket's answer for queries h (hc: h or h*GOLDEN, the hash its
    tags come from): (screened bool, value int64), the value that of the
    first slot whose tag screens, 0 where its confirm word is not h's low
    32 bits."""
    eq = i32_to_u32(ptags[b]) == lsr(hc << lb, 32)[:, None]
    crow = i32_to_u32(confirm[2 * b + (~eq[:, 0]).long()])
    screened = eq.any(dim=1)
    return screened, torch.where(screened & (crow[:, 0] == (h & 0xFFFFFFFF)), crow[:, 1], 0)


def probe_rows_rounds(ptags, confirm, h, lb: int):
    """The `rows_probe` kernel's rounds in plain torch: each query's first
    bucket's tag row and the confirm row of its first screened slot; where
    no slot screens and the buckets differ, its second bucket's tag row and
    the confirm row of its first screened slot. Returns (value int64 [n],
    where it screened int64 [n]: 1 the first bucket, 2 the second, 0
    neither); the value equals probe_rows_plain's where it found one, and is
    0 elsewhere."""
    hg = h * _GOLDEN
    b1, b2 = lsr(h, 64 - lb), lsr(hg, 64 - lb)
    s1, v1 = _raw_bucket(ptags, confirm, b1, h, h, lb)
    s2, v2 = _raw_bucket(ptags, confirm, b2, hg, h, lb)
    s2 &= ~s1 & (b1 != b2)
    val = torch.where(s1, v1, torch.where(s2, v2, 0))
    return val, torch.where(s1, 1, torch.where(s2, 2, 0))


def probe_fused_plain(fused, h, lb: int):
    """Plain PyTorch fused two-choice probe
    (krakenuniq_tpu.lookup.hash_lookup._probe_fused): returns (found bool
    [n], value int64 [n]) for int64 query hashes `h`."""
    v_bits = lb - 1
    spare_mask = (1 << (32 - lb)) - 1
    hg = h * _GOLDEN
    tax_mask = (1 << v_bits) - 1
    hi_mask = 0xFFFFFFFF & ~tax_mask
    found = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    val = torch.zeros_like(h)
    for hc, choice in ((h, 0), (hg, 1)):
        row = i32_to_u32(fused[lsr(hc, 64 - lb)])  # [n, 4]
        tag = lsr(hc << lb, 32)
        hi = ((hc & spare_mask) << v_bits) | (choice << 31)
        m = (row[:, 0::2] == tag[:, None]) & ((row[:, 1::2] & hi_mask) == hi[:, None])
        # exactness means at most one slot can match; max-combine is a select
        val = torch.maximum(val, torch.where(m, row[:, 1::2] & tax_mask, 0).max(dim=1).values)
        found |= m.any(dim=1)
    return found, val


def probe_fused_rounds(fused, h, lb: int):
    """The `fused_probe` kernel's algorithm in plain torch: each query's
    first-choice row, then its second-choice row only where the first holds
    no nonzero value for it (a nonzero match pins all 64 bits of h, and the
    build stores a key once, so the second row cannot hold it too). Returns
    (value int64 [n], the row that answered int64 [n]: 1 or 2, 0 on a
    miss); the value equals probe_fused_plain's."""
    v_bits = lb - 1
    spare_mask = (1 << (32 - lb)) - 1
    tax_mask = (1 << v_bits) - 1
    hi_mask = 0xFFFFFFFF & ~tax_mask
    vals = []
    for hc, choice in ((h, 0), (h * _GOLDEN, 1)):
        row = i32_to_u32(fused[lsr(hc, 64 - lb)])  # [n, 4]
        tag = lsr(hc << lb, 32)
        hi = ((hc & spare_mask) << v_bits) | (choice << 31)
        m = (row[:, 0::2] == tag[:, None]) & ((row[:, 1::2] & hi_mask) == hi[:, None])
        vals.append(torch.where(m, row[:, 1::2] & tax_mask, 0).max(dim=1).values)
    v1, v2 = vals
    second = v1 == 0
    val = torch.where(second, v2, v1)
    answered = torch.where(~second, 1, torch.where(v2 != 0, 2, 0))
    return val, answered


def probe_chd_plain(disp4, rows, h, lr: int):
    """Plain PyTorch CHD probe (krakenuniq_tpu.lookup.hash_lookup._probe_chd):
    returns (found bool [n], value int64 [n]) for int64 query hashes `h`."""
    lg = _chd_widths(disp4, rows)[1]
    p = lsr(h, 64 - lr)
    r = h & ((1 << (64 - lr)) - 1)
    g = lsr(r * _GOLDEN, 64 - lg)
    q = lsr(r * _C2, 64 - lr)
    d = i32_to_u32(disp4.reshape(-1)[g])
    row = (p + (d & 0xFFFF) + (d >> 16) * q) & ((1 << lr) - 1)
    rw = i32_to_u32(rows[row])  # [n, 4]
    v_mask = (1 << lr) - 1
    hi_mask = 0xFFFFFFFF & ~v_mask
    e_hi = r >> (32 - lr)
    e_lo = (r & ((1 << (32 - lr)) - 1)) << lr
    m0 = (rw[:, 0] == e_hi) & ((rw[:, 1] & hi_mask) == e_lo)
    m1 = (rw[:, 2] == e_hi) & ((rw[:, 3] & hi_mask) == e_lo)
    # exactness: at most one REAL slot matches; empty slots match only
    # r == 0 queries and contribute value 0 = miss, so max-combine is safe
    zero = torch.zeros_like(r)
    val = torch.maximum(
        torch.where(m0, rw[:, 1] & v_mask, zero), torch.where(m1, rw[:, 3] & v_mask, zero)
    )
    return m0 | m1, val


def hash_lookup_plain(planes, hashes, valid):
    """Plain version of `hash_lookup_kmers`: value word per lane (int32), 0
    where missing or invalid."""
    layout, h = table_layout(planes), hashes.reshape(-1)
    if layout == "fused":
        ok, val = probe_fused_plain(planes[0], h, _fused_width(planes[0]))
    elif layout == "raw":
        ok, val = probe_rows_plain(*planes, h, _raw_width(*planes))
    else:
        ok, val = probe_chd_plain(*planes, h, _chd_widths(*planes)[0])
    ok = ok & valid.reshape(-1)
    return u32_to_i32(torch.where(ok, val, torch.zeros_like(val))).reshape(hashes.shape)


def _probe_args(name: str, planes, hashes: torch.Tensor, valid: torch.Tensor, **more):
    """Check a probe's operands for the kernel; returns (device, width):
    lb of a fused or raw table, (lr, lg) of a CHD one."""
    layout = table_layout(planes)
    if layout == "fused":
        width = _fused_width(planes[0])
        dev = _kernels.check_cuda(name, fused=planes[0], hashes=hashes, valid=valid, **more)
    elif layout == "raw":
        width = _raw_width(*planes)
        dev = _kernels.check_cuda(name, ptags=planes[0], confirm=planes[1], hashes=hashes, valid=valid, **more)
    else:
        width = _chd_widths(*planes)
        dev = _kernels.check_cuda(name, disp4=planes[0], rows=planes[1], hashes=hashes, valid=valid, **more)
        if not 4 <= width[0] <= 30:
            raise ValueError(f"{name}: rows must be a [2^lr, 4] plane, 4 <= lr <= 30")
    if hashes.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: hashes must be int64 and valid bool")
    if any(p.dtype != torch.int32 for p in planes):
        raise TypeError(f"{name}: table planes must be int32")
    if hashes.shape != valid.shape:
        raise ValueError(f"{name}: shapes {tuple(hashes.shape)} != {tuple(valid.shape)}")
    # the kernels load 16-byte rows, or a raw table's 8-byte tag and confirm rows
    if (any(p.data_ptr() % 8 for p in planes) if layout == "raw" else planes[-1].data_ptr() % 16):
        raise ValueError(f"{name}: the row planes must be aligned to their rows")
    return dev, width


def hash_lookup_kmers(planes, hashes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The stored value per lane (int32: pool ids fit 30 bits, a raw
    table's values are uint32 bit patterns), 0 where missing or invalid.
    `planes` = (disp4, rows), (fused,) or (ptags, confirm); `hashes` int64
    and `valid` bool of one shape. CUDA tensors launch the `chd_probe`,
    `fused_probe` or `rows_probe` kernel."""
    if hashes.device.type == "cpu":
        return hash_lookup_plain(planes, hashes, valid)
    out = torch.empty(hashes.shape, dtype=torch.int32, device=hashes.device)
    layout = table_layout(planes)
    if layout == "fused":
        dev, lb = _probe_args("fused_probe", planes, hashes, valid)
        _kernels.launch("fused_probe", dev, planes[0], hashes, valid, out, hashes.numel(), lb)
    elif layout == "raw":
        dev, lb = _probe_args("rows_probe", planes, hashes, valid)
        _kernels.launch("rows_probe", dev, *planes, hashes, valid, out, hashes.numel(), lb)
    else:
        dev, (lr, lg) = _probe_args("chd_probe", planes, hashes, valid)
        _kernels.launch("chd_probe", dev, *planes, hashes, valid, out, hashes.numel(), lr, lg)
    return out


def probe_values(planes, hashes: torch.Tensor) -> torch.Tensor:
    """The stored value word per hash (int32), 0 on a miss: the raw probe of
    any layout, every lane valid (the JAX package's probe_values)."""
    return hash_lookup_kmers(planes, hashes, torch.ones(hashes.shape, dtype=torch.bool, device=hashes.device))


def hash_lookup_acc_plain(planes, hashes, valid, acc):
    """One chunk table's hits folded into `acc` (int32, the shape of
    `hashes`) in place: the JAX package's probe-all-then-select
    (krakenuniq_tpu/classify/device_step.py:522-531, where(acc != 0, acc,
    word)); returns acc."""
    word = hash_lookup_plain(planes, hashes, valid)
    acc.copy_(torch.where(acc != 0, acc, word))
    return acc
