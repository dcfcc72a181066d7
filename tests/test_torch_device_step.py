"""The port's classify step (krakenuniq_tpu_torch.classify.device_step) on the
CPU against the JAX package's `classify_step` on the golden databases, on
the identical CHD tables (the JAX package's, loaded through
`device_db_from_host`): every output key equal, in hash mode, quick mode and
hierarchical mode."""

import os

import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import classify_step
from krakenuniq_tpu_torch.classify.device_step import StepConfig, classify_step_core
from krakenuniq_tpu_torch.db.device_db import device_db_from_host
from krakenuniq_tpu_torch.formats.seqio import read_sequences
from krakenuniq_tpu_torch.kmer import encode_batch

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _batch():
    seqs = [d.seq for d in read_sequences(os.path.join(DATA, "reads.fa"))]
    seqs += ["", "ACGT" * 3, "N" * 40, "ACGTN" * 20]  # empty, < k, all-N, N-riddled
    return encode_batch(seqs, lb=160, batch=160)


@pytest.mark.parametrize(
    "dbs,quick,min_hits",
    [(["."], False, 1), (["."], True, 2), (["db_bact", "db_viral"], False, 1)],
    ids=["hash", "quick", "hierarchical"],
)
def test_step_matches_jax(dbs, quick, min_hits):
    jc = JaxClassifier(
        [os.path.join(DATA, d) for d in dbs],
        JaxOptions(print_progress=False, use_native=False, quick=quick, min_hits=min_hits),
    )
    assert jc._cfg.lookup_mode == "hash" and jc._cfg.max_runs == 0
    enc = _batch()
    want = classify_step(
        jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
        enc.codes, enc.ambig, enc.lengths, jc._cfg,
    )
    planes = tuple(
        device_db_from_host(
            tuple(np.asarray(p) for p in db.hash_table), db.hash_lb, jc._pool, jc.k, jc.nt, "cpu"
        ).hash_table
        for db in jc.dbs
    )
    t = lambda a, dt: torch.from_numpy(np.array(a).view(dt))
    cfg = StepConfig(
        k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick, min_hits=min_hits
    )
    got = classify_step_core(
        planes, t(jc._taxid_table, np.int32),
        torch.stack([t(jc._tin, np.int32), t(jc._tout, np.int32)], dim=1),
        t(jc._parent, np.int32), int(jc._root_dense),
        torch.from_numpy(enc.codes), torch.from_numpy(enc.ambig), torch.from_numpy(enc.lengths),
        cfg,
    )
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert (np.asarray(want["call"]) != 0).any()
