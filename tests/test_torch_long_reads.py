"""The port's long-read route on the CPU against the JAX package, with exact
equality: the step without the device's tree resolution (resolve=False,
with_kmers=True) in the three lookup modes, `_classify_long_read`'s seven
results, and the runs of the JAX package's tests/test_long_reads.py and
tests/test_outofcore.py::test_ooc_python_path_and_long_reads through the
port's Classifier, each byte-equal to the JAX Classifier's under the same
options and held to the JAX tests' own checks. The JAX runs are cached per
module (`_jax_run`)."""

import dataclasses
import functools
import io
import os
import shutil

import numpy as np
import pytest
import torch

import krakenuniq_tpu.db.device_db as jax_device_db
import krakenuniq_tpu.db.hash_table as jax_hash_table
import reference_oracle as oracle
from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import classify_step
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.db import chunked, device_db
from krakenuniq_tpu_torch.db.hash_table import HashBuildError
from krakenuniq_tpu_torch.formats import read_kdb
from krakenuniq_tpu_torch.formats.kdb import read_header
from krakenuniq_tpu_torch.formats.seqio import read_sequences
from krakenuniq_tpu_torch.kmer import encode_batch
from krakenuniq_tpu_torch.taxonomy import Taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")
K = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genomes():
    return {d.id: d.seq for d in read_sequences(os.path.join(DATA, "library.fna"))}


@pytest.fixture(scope="module")
def long_fa(tmp_path_factory):
    """The JAX tests' make_long_reads (tests/test_long_reads.py:21-29): a
    40,000-base read of seq_211 repeats, a short read and a 35,000-base read
    of seq_311 repeats."""
    g = _genomes()
    long_seq = (g["seq_211"] * 30)[:40_000]
    path = tmp_path_factory.mktemp("long") / "long.fa"
    with open(path, "w") as f:
        f.write(f">long_read\n{long_seq}\n")
        f.write(f">short_read\n{g['seq_311'][100:250]}\n")
        f.write(f">long2\n{(g['seq_311'] * 30)[:35_000]}\n")
    return str(path), long_seq


@pytest.fixture(scope="module")
def ooc_long_fa(tmp_path_factory):
    """test_ooc_python_path_and_long_reads' input: a 3,000-base read of the
    golden reads' bases and the first four golden reads."""
    src = open(READS).read().splitlines()
    long_seq = "".join(l for l in src if not l.startswith(">"))[:3000]
    path = tmp_path_factory.mktemp("ooc_long") / "long.fa"
    path.write_text(f">long1\n{long_seq}\n" + "\n".join(src[:8]) + "\n")
    return str(path)


def _tiny_budget(frac=4):
    """A --preload-size that cuts the golden table into at least `frac` chunks."""
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    hdr = read_header(os.path.join(DATA, "database.kdb"))
    return max(1024, chunked.table_bytes(hdr.key_ct, tax.size - 1, False) // frac)


def _run(reads, **opts):
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue(), c


@functools.lru_cache(maxsize=None)
def _jax_run_cached(reads, opts):
    c = JaxClassifier([DATA], JaxOptions(print_progress=False, **dict(opts)))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue()


def _jax_run(reads, **opts):
    """The JAX Classifier's kraken output and report (cached per module)."""
    return _jax_run_cached(reads, tuple(sorted(opts.items())))


def _both(reads, **opts):
    """The port's run, held byte-equal to the JAX package's under the same
    options; returns the port's (kraken, report, classifier)."""
    out, rep, c = _run(reads, **opts)
    want_out, want_rep = _jax_run(reads, **opts)
    assert out == want_out
    assert rep == want_rep
    return out, rep, c


def _expected_call(seq):
    """The reference oracle's call for a read (tests/test_long_reads.py:32)."""
    _, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    kv = dict(zip(keys.tolist(), vals.tolist()))
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    hits = {}
    for km, amb in oracle.scan_kmers(seq, K):
        if not amb:
            t = kv.get(oracle.canon(km, K), 0)
            if t:
                hits[t] = hits.get(t, 0) + 1
    return oracle.resolve_tree(hits, tax.parent_map())


# --------------------------------------------- the step without the resolve


def _long_feed():
    """Long-read chunk rows (1,024 bases of genome repeats with N runs) and
    the golden reads' edge rows: empty, shorter than k, k - 1 and k bases,
    all N."""
    g = _genomes()
    rng = np.random.default_rng(11)
    seqs = []
    for sid in ("seq_211", "seq_311", "seq_222"):
        s = list((g[sid] * 3)[:1024])
        for at in rng.integers(0, 1000, size=4):
            s[at : at + 5] = "NNNNN"
        seqs.append("".join(s))
    seqs += [d.seq for d in list(read_sequences(READS))[:20]]
    seqs += ["", "ACGT" * 3, "ACGTA" * 4, "ACGTAC" * 3 + "ACG", "N" * 40, "ACGTN" * 20]
    enc = encode_batch(seqs, lb=1024, batch=32)
    return enc.codes, enc.ambig, enc.lengths


def _fail_build(monkeypatch):
    """Every table build fails in both packages: the binary search."""
    for mod, error in ((device_db, HashBuildError), (jax_device_db, jax_hash_table.HashBuildError)):
        def boom(*a, _error=error, **k):
            raise _error("forced failure")

        monkeypatch.setattr(mod, "build_hash_table", boom)


def _db_copy(tmp_path):
    d = tmp_path / "db"
    d.mkdir()
    for name in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
        shutil.copy(os.path.join(DATA, name), d / name)
    return str(d)


@pytest.mark.parametrize("mode", ["hash", "bsearch", "acc"])
def test_step_without_resolve_matches_jax(mode, monkeypatch, tmp_path):
    """classify_step_core with resolve=False, with_kmers=True (the long-read
    step's config) against the JAX classify_step under the same config:
    every output equal (taxa, ambig, enc, canon, hits, n_kmers, processed),
    the calls all 0, in lookup_mode "hash", "bsearch" (every table build
    failed) and "acc" (out of core), each package on its own tables."""
    db, opts = DATA, {}
    if mode == "bsearch":
        _fail_build(monkeypatch)
        db = _db_copy(tmp_path)
    elif mode == "acc":
        opts = {"preload_size": _tiny_budget()}
    jc = JaxClassifier([db], JaxOptions(print_progress=False, use_native=False, **opts))
    c = Classifier([db], ClassifyOptions(print_progress=False, device="cpu", use_native=False, **opts))
    assert jc._cfg.lookup_mode == c._cfg.lookup_mode == mode
    feed = _long_feed()
    jcfg = dataclasses.replace(jc._cfg, resolve=False, with_kmers=True, max_runs=0, quick=False)
    if mode == "acc":
        want = jc._ooc_device_step(*feed, jcfg)
    else:
        want = classify_step(jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
                             *feed, jcfg)
    cfg = dataclasses.replace(c._cfg, resolve=False, with_kmers=True, max_runs=0, quick=False)
    got = c._device_step(*feed, cfg=cfg)
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(w.dtype) if w.dtype.kind == "u" else g, w, err_msg=key)
    assert not got["call"].any() and not got["call_dense"].any()
    assert bool((got["taxa"] != 0).any()) and bool(got["processed"].any())


# ----------------------------------------------------- _classify_long_read


@pytest.mark.parametrize("max_read_len", [4096, 1024])
@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_classify_long_read_matches_jax(long_fa, max_read_len, quick):
    """`_classify_long_read`'s seven results (taxa, ambig, enc, call, hits,
    processed, canon) against the JAX package's for the test reads, at
    max_read_len 4,096 and 1,024, quick (min_hits 3) and not; canon under
    --exact in the resolving case."""
    _, long_seq = long_fa
    seqs = [long_seq, (_genomes()["seq_311"] * 30)[:35_000]]
    exact = not quick
    kw = dict(max_read_len=max_read_len, quick=quick, min_hits=3 if quick else 1, exact=exact)
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False, **kw))
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", use_native=False, **kw))
    for seq in seqs:
        want = jc._classify_long_read(seq)
        got = c._classify_long_read(seq)
        assert len(got) == 7 and len(got[0]) == len(seq) - K + 1
        for i, name in enumerate(("taxa", "ambig", "enc", "call", "hits", "processed", "canon")):
            if want[i] is None:
                assert got[i] is None
                continue
            w = np.asarray(want[i])
            if w.ndim:
                assert got[i].dtype == w.dtype, name
            np.testing.assert_array_equal(got[i], w, err_msg=name)
        assert got[6] is not None if exact else got[6] is None


# ---------------------------------------- the JAX package's long-read tests


def test_long_reads(long_fa):
    """tests/test_long_reads.py::test_long_reads through the port."""
    path, long_seq = long_fa
    out, _, c = _both(path, max_read_len=4096)
    lines = out.splitlines()
    assert len(lines) == 3 and c.n_long_reads == 2
    f0 = lines[0].split("\t")
    assert f0[1] == "long_read" and f0[3] == "40000"
    assert int(f0[2]) == _expected_call(long_seq)
    assert sum(int(p.split(":")[1]) for p in f0[4].split()) == 40_000 - K + 1
    assert lines[1].split("\t")[1:3] == ["short_read", "311"]
    assert lines[2].split("\t")[1] == "long2" and int(lines[2].split("\t")[2]) == 311


@pytest.mark.parametrize("preload", [False, True], ids=["resident", "out-of-core"])
def test_long_reads_native_path_same(long_fa, preload):
    """test_long_reads_native_path_same: the span route (whose chunk with
    long reads falls back to the Python route) and the Python route give
    the same bytes, resident and out of core."""
    path, _ = long_fa
    extra = {"preload_size": _tiny_budget()} if preload else {}
    outs = []
    for native in (True, False):
        out, rep, c = _both(path, max_read_len=4096, use_native=native, **extra)
        assert (c._ooc is not None) == preload and c.n_long_reads == 2
        outs.append(out + rep)
    assert outs[0] == outs[1]


def _rows(report):
    return [line.split("\t") for line in report.splitlines()]


def test_long_reads_exact_mode(long_fa):
    """test_long_reads_exact_mode: --exact composes with the long-read
    chunker; kraken lines equal the HLL run's, and the report's read, call
    and taxon columns too."""
    path, _ = long_fa
    runs = [_both(path, max_read_len=4096, exact=exact) for exact in (False, True)]
    assert runs[0][0] == runs[1][0]
    rows0, rows1 = _rows(runs[0][1]), _rows(runs[1][1])
    assert len(rows0) == len(rows1)
    for a, b in zip(rows0, rows1):
        assert a[1:3] == b[1:3] and a[6:] == b[6:]


@pytest.mark.parametrize("exact", [False, True], ids=["hll", "exact"])
def test_long_reads_device_counters(long_fa, exact):
    """test_long_reads_device_counters: --device-counters composes with the
    long-read chunker (the units with long reads fold on the host under
    sparse tracking; with --exact the counters stay on the card, counts
    only); kraken lines equal, the report's columns by the JAX test's rule."""
    path, _ = long_fa
    runs = [_both(path, max_read_len=4096, device_counters=dc, exact=exact) for dc in (False, True)]
    c = runs[1][2]
    assert c.dev_counters is not None and c.dev_counters.counts_only == exact
    assert runs[0][0] == runs[1][0]
    rows0, rows1 = _rows(runs[0][1]), _rows(runs[1][1])
    assert len(rows0) == len(rows1)
    for a, b in zip(rows0[1:], rows1[1:]):
        assert a[0:3] == b[0:3] and a[6:] == b[6:]
        ka, kb = float(a[3]), float(b[3])
        assert abs(ka - kb) <= 0.05 * max(ka, kb, 1.0), (a, b)


def test_ooc_python_path_and_long_reads(ooc_long_fa):
    """tests/test_outofcore.py::test_ooc_python_path_and_long_reads: the
    Python-record route (print_sequence) and the long-read chunker both run
    through the chunk passes, byte-equal to the resident runs."""
    budget = _tiny_budget()
    kw = {"print_sequence": True, "max_read_len": 1 << 15}
    out0, rep0, c0 = _both(READS, **kw)
    out1, rep1, c1 = _both(READS, preload_size=budget, **kw)
    assert c1._ooc is not None and c0.route == c1.route == "python"
    assert out0 == out1 and rep0 == rep1
    kw2 = {"max_read_len": 1024}
    out2, rep2, _ = _both(ooc_long_fa, **kw2)
    out3, rep3, c3 = _both(ooc_long_fa, preload_size=budget, **kw2)
    assert c3._ooc is not None and c3.n_long_reads == 1
    assert out2 == out3 and rep2 == rep3
