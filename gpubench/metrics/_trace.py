"""What a traced run (`--trace 1`) records around the program, and the
reduction of torch.profiler's timeline to the numbers the readers take.

`Instruments` wraps, for the window only, the entry points of the port's
kernels on the span route (the functions the step calls by module name):
each launch keeps references to its tensors, and the bounds
(metrics/_bounds.py) are worked out from them once the window has closed,
so that the window runs no work of the instruments on the card. It also
wraps the Classifier's span stages in profiler ranges ("gpubench.<stage>"),
which name what the host was doing in each idle gap of the card.

The names of the program each instrument depends on, which a change to the
program that renames or fuses them has to carry over here:
  * the rooflines' bounds (kernels_roofline, chd_probe_roofline,
    chd_probe_acc_roofline):
    device_step.kmer_front_words, device_step.hash_lookup_kmers,
    taxonomy.resolve.scores, device_step.pack_runs (module attributes the
    span step calls by name) and pipeline.probe_chunk_core (out of core);
  * the idle gaps' labels: the Classifier's methods in STAGES;
  * the kernels' card time: the CUDA symbols in SYMBOLS.
A roofline whose kernel is no longer reached reads nothing and is left out.

`summarize` reads the profiler's events: each kernel's card seconds and
record count, matched by symbol (SYMBOLS, a copy of chip_smoke.py's table);
the union of every card record (kernels, copies, sets) inside the window;
the ops with the most card time and the longest idle gaps.
"""

from __future__ import annotations

import functools

import torch

from . import _bounds

# the CUDA symbol of each entry point (a substring of the profiler's name)
SYMBOLS = {
    "kmer_front": ("kmer_front_kernel", "kmer_front_packed_kernel"),
    "chd_probe": ("chd_probe_kernel",),
    "chd_probe_acc": ("chd_probe_acc_kernel",),
    "scores": ("scores_kernel",),
    "pack_runs": ("pack_runs_kernel",),
}
WINDOW = "gpubench.window"
STAGES = ("_start_native_span", "_start_ooc_span", "_ooc_probe_group", "_finish_native_span", "write_report")


class Instruments:
    def __init__(self, classifier):
        from krakenuniq_tpu_torch.classify import device_step, pipeline
        from krakenuniq_tpu_torch.taxonomy import resolve

        self.c = classifier
        self.bound_ms = {name: None for name in SYMBOLS}
        self.launches = {name: 0 for name in SYMBOLS}
        self._saved = []

        # the resident kernels' inputs are kept until the window has closed
        # and their bounds summed then, so that the window runs no work of
        # the instruments on the card
        self._kept = []

        def front(fn, codes, ambig, k_, p, canon=False):
            out = fn(codes, ambig, k_, p, canon)
            if codes.is_cuda:
                self._kept.append(("kmer_front", _bounds.front_words, (codes.shape[0], 16 * codes.shape[1], k_,
                                                                       canon)))
            return out

        def probe(fn, planes, hashes, search, *a, **kw):
            out = fn(planes, hashes, search, *a, **kw)
            if hashes.is_cuda:
                self._kept.append(("chd_probe", _bounds.probe, (search,)))
            return out

        def scores(fn, tins, touts, hit):
            out = fn(tins, touts, hit)
            if hit.is_cuda:
                self._kept.append(("scores", _bounds.scores, (hit,)))
            return out

        def pack(fn, ids, kmer_ambig, n_kmers, *a, **kw):
            out = fn(ids, kmer_ambig, n_kmers, *a, **kw)
            if ids.is_cuda:
                rows = out[0] if isinstance(out, tuple) else out
                self._kept.append(("pack_runs", _bounds.rle, (n_kmers, ids.shape[1], rows.shape[1],
                                                              bool(kw.get("hll16")), kw.get("hll_stop") is not None)))
            return out

        # out of core each chunk pass's tensors are kept, not read: the
        # word plane as the span's last pass leaves it, the feed and the
        # chunk's plane sizes; bounds_s sums the passes' bounds from them
        self._acc = {}

        def acc(fn, acc_, planes, bounds, codes, ambig, lengths, k_, nt, *a, **kw):
            if codes.is_cuda:
                rec = self._acc.setdefault(id(acc_), (acc_, codes, ambig, lengths, k_, nt, []))
                rec[6].append([p.numel() * p.element_size() for p in planes])
            return fn(acc_, planes, bounds, codes, ambig, lengths, k_, nt, *a, **kw)

        self._targets = [(device_step, "kmer_front_words", front), (device_step, "hash_lookup_kmers", probe),
                         (resolve, "scores", scores), (device_step, "pack_runs", pack),
                         (pipeline, "probe_chunk_core", acc)]

    def __enter__(self):
        for mod, name, wrap in self._targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, functools.partial(wrap, fn))
        for stage in STAGES:
            fn = getattr(self.c, stage)
            self._saved.append((self.c, stage, None))
            setattr(self.c, stage, _ranged(f"gpubench.{stage.strip('_')}", fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
        self._saved.clear()

    def bounds_s(self) -> dict:
        """Each kernel's summed bound over the window, seconds, worked out
        once the window has closed from the tensors the launches kept."""
        for name, fn, args in self._kept:
            self._add(name, fn(*args))
        self._kept.clear()
        for acc_, codes, ambig, lengths, k_, nt, passes in self._acc.values():
            for bound in _acc_bounds(acc_, codes, ambig, lengths, k_, nt, passes):
                self._add("chd_probe_acc", bound)
        self._acc.clear()
        return {n: (float(v) / 1e3 if v is not None else 0.0) for n, v in self.bound_ms.items()}

    def _add(self, name, value) -> None:
        b = self.bound_ms[name]
        self.bound_ms[name] = value if b is None else b + value
        self.launches[name] += 1


def _acc_bounds(acc_, codes, ambig, lengths, k_, nt, passes):
    """One span's chunk passes' bounds (_bounds.probe_acc). Exact in sum
    over the passes: the lanes in the reads, the hits (each lane is set by
    the one pass of the chunk that owns its bin) and the searched lanes
    (free of N), each pass taken to probe the span's searched lanes over
    the passes. The rows still unset when the span's last pass has run
    stand for each pass's rows still unset, which is a lower bound: a row
    whose every lane hit counts in none of the passes before it filled."""
    b, w = acc_.shape
    lb = 16 * codes.shape[1]
    dev = codes.device
    in_read = torch.arange(w, device=dev)[None, :] < (lengths - (k_ - 1)).clamp(min=0)[:, None]
    bits = (ambig[:, :, None] >> torch.arange(32, device=dev)) & 1
    bad = torch.zeros((b, lb + 1), dtype=torch.int32, device=dev)
    bad[:, 1:] = torch.cumsum(bits.reshape(b, lb), dim=1)
    clean = (bad[:, k_:k_ + w] - bad[:, :w]) == 0
    n = len(passes)
    searched = (in_read & clean).sum(dtype=torch.float64)
    hits = (acc_ != 0).sum(dtype=torch.float64)
    unset_rows = (in_read & (acc_ == 0)).any(dim=1).sum(dtype=torch.float64)
    lanes = in_read.sum(dtype=torch.float64)
    return [_bounds.probe_acc(lb, k_, nt, lanes, unset_rows, searched / n, hits / n, plane_bytes)
            for plane_bytes in passes]


def _ranged(label: str, fn):
    @functools.wraps(fn)
    def call(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return call


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """The window's card records: seconds by kernel, busy and window
    seconds, the top ops and the longest idle gaps (microsecond clock of
    the profiler)."""
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW]
    if not win:
        raise RuntimeError("the profiler kept no window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    # the card's records: kernels, copies and sets, not the ranges the
    # profiler mirrors onto the card's timeline for each record_function
    card = [e for e in events if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("gpubench.") and e.time_range.end > w0 and e.time_range.start < w1]
    kernels = {}
    for name, syms in SYMBOLS.items():
        recs = [e for e in card if any(s in e.name for s in syms)]
        kernels[name] = {"records": len(recs), "device_s": sum(e.time_range.elapsed_us() for e in recs) / 1e6}
    busy = _union((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in card)
    busy_us = sum(e - s for s, e in busy)
    by_op = {}
    for e in card:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    stages = [e for e in events if e.name.startswith("gpubench.") and e.name != WINDOW]

    def label(s, e):
        mid = (s + e) / 2
        inside = [x for x in stages if x.time_range.start <= mid < x.time_range.end]
        if not inside:
            return "host: parse and pass turns (no stage)"
        return "host: " + max(inside, key=lambda x: x.time_range.start).name[len("gpubench."):]

    return {
        "kernels": kernels,
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[name[:120], s] for name, s in ops],
        "idle_gaps": [[label(s, e), g / 1e6] for g, s, e in gaps],
    }
