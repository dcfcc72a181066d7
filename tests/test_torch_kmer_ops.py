"""The port's k-mer front (krakenuniq_tpu_torch.kmer.ops and the plain
`kmer_front` of classify/device_step.py) against the JAX package on the same
numpy inputs. Every output is an integer or a bool: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import device_step as jds
from krakenuniq_tpu.kmer import ops as jops
from krakenuniq_tpu.utils import bits
from krakenuniq_tpu_torch import ints
from krakenuniq_tpu_torch.classify import device_step as tds
from krakenuniq_tpu_torch.kmer import encode_batch
from krakenuniq_tpu_torch.kmer import ops as tops


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _reads(rng, n=24, lb=96):
    """Random reads with N bases, one read shorter than k and one empty."""
    seqs = []
    for i in range(n):
        length = int(rng.integers(40, lb + 1))
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].copy()
        if i % 3 == 0:
            s[rng.integers(0, length, 2)] = ord("N")
        seqs.append(s.tobytes().decode())
    seqs[1] = "ACGTACGTAC"
    seqs[2] = ""
    return encode_batch(seqs, lb=lb, batch=n + 8)


@pytest.mark.parametrize("k", [21, 31])
def test_pack_revcomp_canonical(rng, k):
    enc = _reads(rng)
    codes_t = torch.from_numpy(enc.codes)
    packed = tops.pack_windows(codes_t, k)
    want = np.asarray(jops.pack_windows(jnp.asarray(enc.codes), k))
    np.testing.assert_array_equal(_u64(packed), want)
    np.testing.assert_array_equal(
        _u64(tops.reverse_complement(packed, k)),
        np.asarray(jops.reverse_complement(jnp.asarray(want), k)),
    )
    np.testing.assert_array_equal(
        _u64(tops.canonical_representation(packed, k)),
        np.asarray(jops.canonical_representation(jnp.asarray(want), k)),
    )


@pytest.mark.parametrize("k", [21, 31])
def test_window_any(rng, k):
    flags = rng.random((9, 120)) < 0.03
    got = tops.window_any(torch.from_numpy(flags), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.window_any(jnp.asarray(flags), k)))


def _edge_hashes(rng):
    """Random 64-bit values plus the encoder's edges: low 39 bits zero
    (shifted == 0 -> clz 64, clamped to 39), clz exactly at and around the
    clamp, and sparse-index flags (bits 39..51 zero) at every clz."""
    h = rng.integers(0, 2**63, size=4000, dtype=np.uint64) * np.uint64(2) | rng.integers(
        0, 2, size=4000, dtype=np.uint64
    )
    top = rng.integers(0, 2**25, size=64, dtype=np.uint64) << np.uint64(39)
    low = [np.uint64(0)] + [np.uint64(1) << np.uint64(b) for b in range(39)]
    edges = (top[:, None] | np.asarray(low, np.uint64)[None, :]).reshape(-1)
    flagged = edges & ~(np.uint64((1 << 13) - 1) << np.uint64(39))
    return np.concatenate([h, edges, flagged, np.asarray([0, 2**64 - 1], np.uint64)])


def test_murmur_and_encode_hash(rng):
    keys = _edge_hashes(rng)
    kt = torch.from_numpy(keys.view(np.int64))
    got = tds.murmur3_finalizer_device(kt)
    np.testing.assert_array_equal(
        _u64(got), np.asarray(jds.murmur3_finalizer_device(jnp.asarray(keys)))
    )
    np.testing.assert_array_equal(_u64(got), bits.murmur3_finalizer(keys))
    for p in (12, 14, 18):
        np.testing.assert_array_equal(
            tds.encode_hash_device(kt, p).numpy().view(np.uint32),
            np.asarray(jds.encode_hash_device(jnp.asarray(keys), p)),
        )


def test_int64_helpers(rng):
    x = _edge_hashes(rng)
    xt = torch.from_numpy(x.view(np.int64))
    np.testing.assert_array_equal(ints.clz64(xt).numpy(), bits._clz64(x).astype(np.int64))
    for s in (1, 7, 33, 63):
        np.testing.assert_array_equal(_u64(ints.lsr(xt, s)), x >> np.uint64(s))
    y = np.roll(x, 1)
    np.testing.assert_array_equal(
        ints.ult(xt, torch.from_numpy(y.view(np.int64))).numpy(), x < y
    )


@pytest.mark.parametrize("k,p", [(21, 12), (31, 14)])
def test_kmer_front_plain_matches_jax_front(rng, k, p):
    enc = _reads(rng, lb=128)
    h, e, a = tds.kmer_front(
        torch.from_numpy(enc.codes), torch.from_numpy(enc.ambig), k, p
    )
    canon = jops.canonical_representation(jops.pack_windows(jnp.asarray(enc.codes), k), k)
    jh = jds.murmur3_finalizer_device(canon)
    np.testing.assert_array_equal(_u64(h), np.asarray(jh))
    np.testing.assert_array_equal(
        e.numpy().view(np.uint32), np.asarray(jds.encode_hash_device(jh, p))
    )
    np.testing.assert_array_equal(a.numpy(), np.asarray(jops.window_any(jnp.asarray(enc.ambig), k)))


def _front_case(rng, lb):
    """Random codes with ~3% N (code 0, flagged) and per-row padding."""
    b = 12
    codes = rng.integers(0, 4, size=(b, lb), dtype=np.uint8)
    ambig = rng.random((b, lb)) < 0.03
    pad = np.arange(lb)[None, :] >= rng.integers(0, lb + 1, size=b)[:, None]
    ambig |= pad
    codes[ambig] = 0
    return codes, ambig


@pytest.mark.parametrize("lb", [37, 160, 161])
def test_pack_input_round_trips_through_jax_unpack_input(rng, lb):
    """The kernel's packed layout is encode_unit_packed's: the reference's
    unpack_input reads `pack_input`'s words back to the codes and flags."""
    codes, ambig = _front_case(rng, lb)
    cp, ap = tds.pack_input(torch.from_numpy(codes), torch.from_numpy(ambig))
    uc, ua = jds.unpack_input(jnp.asarray(cp.numpy().view(np.uint32)), jnp.asarray(ap.numpy().view(np.uint32)))
    uc, ua = np.asarray(uc), np.asarray(ua)
    np.testing.assert_array_equal(uc[:, :lb], codes)
    np.testing.assert_array_equal(ua[:, :lb], ambig)
    assert not uc[:, lb:].any() and not ua[:, lb:].any()


@pytest.mark.parametrize("k,lb", [(21, 37), (21, 160), (21, 161), (31, 37), (31, 160), (31, 161)])
def test_kmer_front_packed_matches_plain_and_jax(rng, k, lb):
    """The kernel's algorithm from packed words (funnel-shift windows,
    complement by inversion, forward k-mer by 2-bit reversal) equals
    `kmer_front_plain` and the JAX front."""
    codes, ambig = _front_case(rng, lb)
    p = 14 if k == 21 else 12
    ct, at = torch.from_numpy(codes), torch.from_numpy(ambig)
    got = tds.kmer_front_packed(*tds.pack_input(ct, at), lb, k, p)
    for g, w in zip(got, tds.kmer_front_plain(ct, at, k, p)):
        assert torch.equal(g, w)
    canon = jops.canonical_representation(jops.pack_windows(jnp.asarray(codes), k), k)
    jh = jds.murmur3_finalizer_device(canon)
    np.testing.assert_array_equal(_u64(got[0]), np.asarray(jh))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(jds.encode_hash_device(jh, p)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jops.window_any(jnp.asarray(ambig), k)))
