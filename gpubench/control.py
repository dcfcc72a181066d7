"""The control of the benchmark's check: the plain reference put in the
program's place with one guarantee of the configuration broken, the exact
match of every k-mer on all its bits. The control matches k-mers on the top
32 bits of their murmur3 hash, as a compact table that keeps fingerprints
instead of keys would; the check (harness.compare) must find it wrong.

    python3 gpubench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers the check compares for the
control (its upper readings). The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(db_dir: str, reads) -> dict:
    from gpubench import harness
    from gpubench.reference import classify as reference

    ref = reference.run(db_dir, reads)
    ctl = reference.run(db_dir, reads, lookup="fingerprint32")
    checks, _ = harness.compare(ref, ctl.lines, ctl.report)
    return {name: v["value"] for name, v in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from gpubench import harness
    from gpubench.synth import database, reads as synth_reads

    cell, config, traffic = harness.resolve_cell(harness.manifest(ROOT), args.workload, ROOT)
    spec = {key: config[key] for key in ("k", "minimizer_len", "species", "genome_len", "species_per_genus",
                                         "divergence", "keys", "taxonomy_nodes", "db_seed")}
    spec["name"] = config["database"]
    db_dir, _ = database.ensure(spec, harness.DATA, "cuda" if torch.cuda.is_available() else "cpu")
    genomes = np.load(os.path.join(db_dir, "genomes.npy"))
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(db_dir, synth_reads.make(traffic, genomes, seed))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
