"""The check catches a broken timed path: the rest of a run is driven on the
CPU (harness.run_cell) with one fault planted underneath, and `correct`
comes out false. The cells have no exchange between chips, so that fault
has no case."""

import pytest

from conftest import run_toy


def _unchanged_state(monkeypatch):
    # the counters' update returns their state unchanged
    from krakenuniq_tpu_torch.classify.accumulate import TaxonCounter

    monkeypatch.setattr(TaxonCounter, "process_unit", lambda self, *a, **kw: None)


def _half_the_batch(monkeypatch):
    # each span keeps its first half of the work units: the rest is neither
    # written nor counted
    from krakenuniq_tpu_torch.classify.pipeline import Classifier

    orig = Classifier._iter_native_spans

    def spans(self, path):
        for kind, buf, offs, bounds, fastq in orig(self, path):
            if kind == "span" and len(bounds) > 2:
                m = (len(bounds) - 1) // 2
                offs, bounds = offs[: bounds[m]], bounds[: m + 1]
            yield kind, buf, offs, bounds, fastq

    monkeypatch.setattr(Classifier, "_iter_native_spans", spans)


def _altered_answer(monkeypatch):
    # the first read of every span gets another call where the step makes it
    from krakenuniq_tpu_torch.classify.pipeline import Classifier

    orig = Classifier._slice_and_prefetch

    def altered(self, out, b, n_span):
        r = self._cfg_packed.max_runs
        out["packed"][0, r] ^= 1 << 16
        return orig(self, out, b, n_span)

    monkeypatch.setattr(Classifier, "_slice_and_prefetch", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch, _altered_answer],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ["refseq-k31.illumina150", "refseq-k31-ooc8.illumina150"])
def test_fault_is_not_correct(bench, data_dir, monkeypatch, fault, workload):
    fault(monkeypatch)
    out = run_toy(bench, workload, data_dir, 2147483713)
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["checks"].values())
