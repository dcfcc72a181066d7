"""One run of one cell: set-up, the measured window, the check against the
plain reference and the result line.

Set-up builds the configuration's database once (synth/database.py, into
`_data/<database>/`, where the port also keeps its table caches), draws the
traffic mix's sample from the seed into FASTQ files under TMPDIR, builds
`Classifier([db], ClassifyOptions(device="cuda", print_progress=False,
**config["classify"]))` and runs it once over the warm-up reads with a
report, so that the kernels are built and loaded and every allocation the
window makes has been made once. The window then classifies the sample as
a lab does, `Classifier.run` over it and `write_report` over its counts,
sample after sample from zeroed counters, until `seconds` have passed: the
report's share of the window is the same whatever the number of samples.
After the window closes, the reference works out every read's kraken line
and the report's numbers from the database's pairs and the reads, and the
run is correct when the last sample's lines and report equal them.

A fixed host probe (hostprobe.py) runs at the start of set-up and after the
window; it goes on the result line under "host", beside the metrics and the
process's CPU seconds in the window, so that a run that reads slow can be
told from a host that ran slow.

Metrics are read by the readers under metrics/, one file a metric, named as
in BENCHMARK.json; a reader that finds nothing to read returns None and the
metric is left out of the line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "_data")
FORBIDDEN = ("jax", "jaxlib", "flax", "krakenuniq_tpu")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve_cell(man: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict]:
    """The workload's entry, its configuration file and its traffic file."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json"))
    return cell, config, traffic


def cell_metrics(man: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if ((workload in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def reader(name: str):
    """metrics/<name>.py's `read(ctx)`."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        limit = float(out.stdout.split("\n")[0])
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "power_limit_w": limit}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _table_timings(c) -> dict:
    parts = [db.timings for db in c.dbs] if c._ooc is None else [cdb.timings for cdb in c._ooc]
    out: dict = {}
    for t in parts:
        for key, v in t.items():
            # "build_*" split "build" into its steps
            if isinstance(v, (int, float)) and not key.startswith("build_"):
                out[key] = out.get(key, 0.0) + v
    return out


def run_cell(cell: dict, config: dict, traffic: dict, metrics: list[dict], seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda", data_dir: str = DATA) -> dict:
    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    from . import hostprobe
    from .reference import classify as reference
    from .synth import database, reads as synth_reads

    cuda = device == "cuda"
    host = {"start": hostprobe.measure()}
    db_spec = {key: config[key] for key in ("k", "minimizer_len", "species", "genome_len", "species_per_genus",
                                             "divergence", "keys", "taxonomy_nodes", "db_seed")}
    db_spec["name"] = config["database"]
    t = time.perf_counter()
    db_dir, built = database.ensure(db_spec, data_dir, device)
    synth_s = time.perf_counter() - t
    if built:
        log(f"database {config['database']} made in {synth_s:.1f} s: {built}")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the database is the lab's, made once
    t = time.perf_counter()
    reads = synth_reads.make(traffic, np.load(os.path.join(db_dir, "genomes.npy")), seed)
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        sample = os.path.join(tmp, "sample.fq")
        warm = os.path.join(tmp, "warmup.fq")
        synth_reads.write_fastq(sample, reads)
        synth_reads.write_fastq(warm, reads, traffic["warmup_reads"])
        reads_s = time.perf_counter() - t
        t = time.perf_counter()
        c = Classifier([db_dir], ClassifyOptions(device=device, print_progress=False, **config["classify"]))
        load_s = time.perf_counter() - t
        tables = _table_timings(c)
        t = time.perf_counter()
        kraken = os.path.join(tmp, "kraken.out")
        report = os.path.join(tmp, "report.tsv")
        with open(kraken, "w") as kf:
            c.run([warm], kraken_fh=kf)
        with open(report, "w") as rf:
            c.write_report(rf)
        if cuda:
            torch.cuda.synchronize()
        # this run's writes (the sample; on a checkout's first run also the
        # database and the port's table cache) reach the disk now, and not
        # as writeback inside the window
        os.sync()
        warmup_s = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: database {synth_s:.3f}, reads {reads_s:.3f}, load {load_s:.3f} "
            f"(tables {sum(tables.values()):.3f}: {tables}), warm-up and sync {warmup_s:.3f}")

        window, counters, trace_sum = _window(c, sample, kraken, report, seconds, trace, cuda)
        host["window_cpu_s"] = window.pop("cpu_s")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
        ctx = {"classifier": c, "cell": cell, "config": config, "traffic": traffic, "window": window,
               "counters": counters,
               "setup": {"setup_s": setup_s, "load_s": load_s, "load_tables_s": sum(tables.values()),
                         "synth_s": synth_s, "reads_s": reads_s, "warmup_s": warmup_s},
               "peak_bytes": peak, "trace": trace_sum}
        values = {}
        for m in metrics:
            v = reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"window {window['seconds']:.3f} s, {window['samples']} samples of {window['reads_per_sample']} reads "
            f"({window['reads'] / window['seconds']} reads/s), "
            f"classify {window['classify_s']} s, report {window['report_s']} s; {counters}")
        del c, ctx
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        host["end"] = hostprobe.measure()
        log(f"host {json.dumps(host)}")

        t = time.perf_counter()
        checks, failed = check(db_dir, reads, kraken, report, reference)
        log(f"reference {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = card(device, cell["chips"])
    dev["memory_peak_bytes"] = peak
    if trace_sum is not None:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["window_s"]
    out = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
           "attempted": window["reads"], "failed": failed, "metrics": values, "device": dev}
    if trace_sum is not None:
        out["breakdown"] = {"device_ops": trace_sum["device_ops"], "idle_gaps": trace_sum["idle_gaps"]}
    out["host"] = host
    out["checks"] = checks
    return out


# the program's counters that the readers take, summed over the window's
# samples (reset_counters zeroes them before each)
_COUNTERS = ("n_spans", "host_seconds", "device_seconds", "fetch_seconds", "ooc_groups")


def _counters(c, into: dict) -> None:
    for name in _COUNTERS:
        into[name] = into.get(name, 0) + getattr(c, name)
    stages = into.setdefault("span_host_seconds", {})
    for name, v in c.span_host_seconds.items():
        stages[name] = stages.get(name, 0.0) + v
    into.setdefault("ooc_upload_ms", []).extend(c.ooc_timings()["upload"])


def _window(c, sample, kraken, report, seconds, trace, cuda):
    """The measured window; with `trace`, under torch.profiler with the
    bound and stage instruments, and its summary."""
    import contextlib

    import torch

    from krakenuniq_tpu_torch import _kernels

    from .metrics import _trace

    counters: dict = {}
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            inst = stack.enter_context(_trace.Instruments(c))
        _kernels.reset_launches()
        if cuda:
            torch.cuda.synchronize()
        with torch.profiler.record_function(_trace.WINDOW) if trace else contextlib.nullcontext():
            t_open, cpu_open = time.perf_counter(), time.process_time()
            classify_s, report_s, reads = [], [], 0
            while True:
                c.reset_counters()
                t0 = time.perf_counter()
                with open(kraken, "w") as kf:
                    c.run([sample], kraken_fh=kf)
                t1 = time.perf_counter()
                with open(report, "w") as f:
                    c.write_report(f)
                if cuda:
                    torch.cuda.synchronize()
                t_close = time.perf_counter()
                classify_s.append(t1 - t0)
                report_s.append(t_close - t1)
                reads += c.total_sequences
                _counters(c, counters)
                if t_close - t_open >= seconds:
                    break
            cpu_s = time.process_time() - cpu_open
    window = {"seconds": t_close - t_open, "samples": len(report_s), "reads": reads,
              "reads_per_sample": c.total_sequences, "classify_s": classify_s, "report_s": report_s,
              "cpu_s": cpu_s, "launches": dict(_kernels.LAUNCHES)}
    summary = None
    if trace and cuda:
        summary = _trace.summarize(prof)
        summary["bounds_s"] = inst.bounds_s()
        summary["launches"] = dict(inst.launches)
    return window, counters, summary


def check(db_dir, reads, kraken, report, reference) -> tuple[dict, int]:
    """The numbers compared, each with its limit (compare), for the last
    sample's kraken output and report."""
    ref = reference.run(db_dir, reads)
    with open(kraken, "rb") as f:
        got = f.read().splitlines(keepends=True)
    log(f"compared {len(ref.lines)} kraken lines and {len(ref.report)} report rows")
    return compare(ref, got, reference.parse_report(report))


def compare(ref, lines: list, report: dict) -> tuple[dict, int]:
    """Kraken lines that differ from the reference's (a missing or extra
    line counts) and report rows that differ (a row missing on either side
    counts), each with its limit 0; and the reads whose lines differ."""
    bad_lines = sum(a != b for a, b in zip(lines, ref.lines)) + abs(len(lines) - len(ref.lines))
    bad_rows = sum(report.get(t) != ref.report.get(t) for t in set(report) | set(ref.report))
    checks = {"kraken_lines_differing": {"value": bad_lines, "limit": 0},
              "report_rows_differing": {"value": bad_rows, "limit": 0}}
    return checks, bad_lines
