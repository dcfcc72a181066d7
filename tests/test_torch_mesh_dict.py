"""The mesh's host decisions in the port on the CPU (gloo, spawned ranks):
the span dictionary (a taxonomy past u16 with no value pool) merged over
the data ranks, a span past the dictionary's capacity redispatched on the
wide rows by every rank, and a sparse-buffer overflow that rank 0
broadcasts and every rank redispatches; each byte-equal to the port's
single-device run at the same span geometry (tolerance 0), over many
spans."""

import io
import os

import numpy as np
import pytest
import torch

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.parallel.mesh import run_mesh

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
K, NT = 31, 9
PAD = 70_000  # taxonomy nodes past the u16 range
GEO = {"work_unit_size": 3000, "device_batch_reads": 64}  # 8 spans of the 400 reads
MESH_TIMEOUT = 240  # seconds: a hung rank fails its test


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, and so for the
    ranks it spawns (they share the caller's threads): the suite runs in
    several pytest-xdist workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big_tax_db(tmp_path_factory):
    from krakenuniq_tpu_torch.formats import write_index, write_kdb
    from krakenuniq_tpu_torch.utils.demo import make_demo_db, make_demo_reads

    td = tmp_path_factory.mktemp("mesh_bigtax_db")
    keys, vals, offsets, tax, genomes = make_demo_db(
        n_species=50, genome_len=9000, k=K, nt=NT, species_base=10_000_000, pad_nodes=PAD,
    )
    assert tax.size > 0xFFFF
    write_kdb(os.path.join(td, "database.kdb"), keys, vals, k=K)
    write_index(os.path.join(td, "database.idx"), NT, np.asarray(offsets, dtype=np.uint64))
    tax.write_taxdb(os.path.join(td, "taxDB"))
    reads_path = os.path.join(td, "reads.fa")
    with open(reads_path, "w") as f:
        for i, r in enumerate(make_demo_reads(genomes, n_reads=400, read_len=150)):
            f.write(f">r{i}\n{r}\n")
    return str(td), reads_path


def _single(db, reads, **kw):
    c = Classifier([db], ClassifyOptions(device="cpu", print_progress=False, **kw))
    out, rep = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=out)
    c.write_report(rep)
    return c, out.getvalue(), rep.getvalue()


@pytest.mark.parametrize(
    "name,kw,mesh",
    [
        ("dict", {}, (2, 1)),
        ("dict_overflow", {"dict_capacity": 8}, (2, 2)),
        ("dict_device_counters", {"device_counters": True}, (2, 1)),
        ("dict_quick", {"quick": True, "min_hits": 2}, (2, 1)),
    ],
)
def test_span_dictionary_merges_over_data_ranks(big_tax_db, name, kw, mesh):
    db, reads = big_tax_db
    kw = {"value_pool": False, **GEO, **kw}
    c, out0, rep0 = _single(db, reads, **kw)
    assert c._cfg_packed.local_dict and c.n_spans == 8
    assert (c.dict_overflows == c.n_spans) == (name == "dict_overflow")
    got = run_mesh([db], ClassifyOptions(device="cpu", print_progress=False, mesh_data=mesh[0], mesh_db=mesh[1],
                                         **kw), [reads], timeout=MESH_TIMEOUT)
    assert got["n_spans"] == 8
    assert got["kraken"] == out0
    assert got["report"] == rep0


def test_sparse_overflow_is_redispatched_on_every_rank():
    """A 4-slot sparse buffer overflows on every span: rank 0 broadcasts it,
    every rank runs the span again, rank 0 folds the host stats."""
    kw = {"device_counters": True, "sparse_cap": 4}
    reads = os.path.join(DATA, "reads.fa")
    c, out0, rep0 = _single(DATA, reads, **kw)
    assert c.dev_counters.tracker.overflows == c.n_spans > 0
    got = run_mesh([DATA], ClassifyOptions(device="cpu", print_progress=False, mesh_data=2, mesh_db=2, **kw),
                   [reads], timeout=MESH_TIMEOUT)
    assert got["kraken"] == out0
    assert got["report"] == rep0
