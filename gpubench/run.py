"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name through BENCHMARK.json (harness.py). The run needs as
many CUDA devices as the cell asks for and never falls back to the CPU. Its
last line on standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and checks: each number
compared with its limit, which also end standard error).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "gpubench", "_cache")
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench import harness

    man = harness.manifest(ROOT)
    cell, config, traffic = harness.resolve_cell(man, args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    out = harness.run_cell(cell, config, traffic, harness.cell_metrics(man, args.workload, bool(args.trace)),
                           args.seed, args.seconds, bool(args.trace), T_START)
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
