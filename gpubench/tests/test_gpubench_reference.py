"""The plain reference against the port's CPU route on a toy database:
every kraken line and every report row equal, resident and out of core, on
the path the benchmark drives (harness.run_cell on the CPU); and the
reference's frozen arithmetic against the program's own."""

import numpy as np
import pytest

from conftest import run_toy


@pytest.mark.parametrize("workload", ["refseq-k31.illumina150", "refseq-k31-ooc8.illumina150"])
@pytest.mark.parametrize("seed", [2147483701, 11])
def test_reference_equals_cpu_route(bench, data_dir, workload, seed):
    out = run_toy(bench, workload, data_dir, seed)
    assert out["checks"]["kraken_lines_differing"]["value"] == 0
    assert out["checks"]["report_rows_differing"]["value"] == 0
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 8000
    assert set(out["metrics"]) == {"setup_s"}  # no card: no peak memory


def test_traced_run_reads_host_metrics(bench, data_dir):
    out = run_toy(bench, "refseq-k31.illumina150", data_dir, 5, trace=True)
    assert out["correct"]
    # the card's metrics stay silent on the CPU; the host's are read
    assert {"window_reads_per_s", "host_ms_per_span", "fold_ms_per_span", "report_s",
            "load_tables_s"} <= set(out["metrics"])
    assert not {"kernels_roofline", "device_idle_pct", "table_gb"} & set(out["metrics"])


def test_frozen_bits_equal_the_programs():
    from gpubench.reference import kmers
    from krakenuniq_tpu_torch.utils import bits

    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 62, size=50000, dtype=np.uint64)
    assert np.array_equal(kmers.canonical(x, 31), bits.canonical_representation(x, 31))
    assert np.array_equal(kmers.bin_key(kmers.canonical(x, 31), 31, 12),
                          bits.bin_key(bits.canonical_representation(x, 31), 31, 12))
    h = kmers.murmur3_finalizer(x)
    assert np.array_equal(h, bits.murmur3_finalizer(x))
    h[:500] >>= np.uint64(45)  # flagged encodings
    for p in (4, 12, 18):
        e = kmers.encode_hash_32(h, p)
        assert np.array_equal(e, bits.encode_hash_32(h, p))
        assert np.array_equal(kmers.decode_rank(e, p), bits.decode_rank(e, p))


@pytest.mark.parametrize("n", [0, 5, 700, 1024, 30000])
def test_frozen_estimate_equals_the_programs(n):
    from gpubench.reference import hll as ref_hll
    from krakenuniq_tpu_torch.hll import HLL
    from krakenuniq_tpu_torch.utils import bits

    rng = np.random.default_rng(n)
    encs = np.unique(bits.encode_hash_32(bits.murmur3_finalizer(rng.integers(0, 1 << 62, n, dtype=np.uint64)), 12))
    h = HLL(12)
    h.insert_encodings(encs)
    h.n_observed = 3 * n
    if h.sparse:
        got = ref_hll.estimate_sparse(h.sparse_set, 12, 3 * n)
    else:
        got = ref_hll.estimate_dense(h.M, 3 * n)
        assert np.array_equal(ref_hll.registers_of(encs, 12), h.M)
    assert got == h.ertl_cardinality()
