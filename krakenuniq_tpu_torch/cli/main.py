"""`krakenuniq-tpu-torch` -- the classifier CLI of the PyTorch/CUDA port.

Flag-compatible with the reference `krakenuniq` wrapper
(scripts/krakenuniq:76-100) for the options this port serves; run it as
`python -m krakenuniq_tpu_torch.cli.main --db DIR reads.fa`. `--device cpu`
runs the plain PyTorch versions of the kernels on the CPU; the default
`cuda` needs a card. As in the reference, `--threads` (default
$KRAKEN_NUM_THREADS) is accepted and unused, `--preload` is a no-op (the
database is resident on the device anyway), and a missing taxDB is written
from the database's taxonomy/{names,nodes}.dmp. `--preload-size SIZE` bounds
the device bytes of the database tables: databases past it are cut into
minimizer-range chunk tables that stream through the card (out of core).
"""

from __future__ import annotations

import argparse
import datetime
import os
import shlex
import sys
import tempfile

from .. import __version__
from .dblib import find_db


def _env_threads() -> int | None:
    """KRAKEN_NUM_THREADS as a thread count (the reference wrapper's
    fallback, krakenuniq:102-104); unset or not a number gives None."""
    try:
        return int(os.environ.get("KRAKEN_NUM_THREADS", "")) or None
    except ValueError:
        return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="krakenuniq-tpu-torch",
        description="Taxonomic sequence classifier with unique k-mer counting (PyTorch/CUDA)",
    )
    p.add_argument("--db", action="append", default=[], help="database directory (repeatable: hierarchical lookup)")
    p.add_argument("--threads", type=int, default=_env_threads(), help="accepted for compatibility")
    p.add_argument("--preload", action="store_true", help="accepted no-op (the database is resident)")
    p.add_argument(
        "--preload-size",
        metavar="SIZE",
        help="device byte budget for the database tables (K/M/G/T suffixes); "
        "databases over it stream through the card in minimizer-range chunks",
    )
    p.add_argument("--fasta-input", action="store_true", help="(format is auto-detected)")
    p.add_argument("--fastq-input", action="store_true", help="(format is auto-detected)")
    p.add_argument("--gzip-compressed", action="store_true", help="(auto-detected)")
    p.add_argument("--bzip2-compressed", action="store_true", help="(auto-detected)")
    p.add_argument("--quick", action="store_true", help="stop after the first hit(s)")
    p.add_argument("--min-hits", type=int, default=1, help="hits required in quick mode")
    p.add_argument("--unclassified-out", metavar="FILENAME")
    p.add_argument("--classified-out", metavar="FILENAME")
    p.add_argument("--print-sequence", action="store_true", help="end each kraken line with the read's sequence")
    p.add_argument("-o", "--output", metavar="FILENAME", help="kraken output ('off' to suppress)")
    p.add_argument("--report-file", metavar="FILENAME", help="report output ('off' to suppress)")
    p.add_argument("--paired", action="store_true", help="two input files are mate pairs")
    p.add_argument("--check-names", action="store_true")
    p.add_argument("--hll-precision", type=int, default=12)
    p.add_argument("--exact", action="store_true", help="exact unique-k-mer counting")
    p.add_argument("--only-classified-output", action="store_true")
    p.add_argument("--full-report", action="store_true", help="report with DB k-mer columns")
    p.add_argument(
        "--device-counters",
        action="store_true",
        help="keep taxon counters on the device (bit-identical to the host "
        "path: the sparse-regime HLL tracking runs on the device, see "
        "classify/sparse_exact.py)",
    )
    p.add_argument("--uid-mapping", action="store_true",
                   help="use the UID database (uid_database.kdb, uid_to_taxid.map)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the tables live and the step runs (default: cuda)")
    p.add_argument("--version", action="version", version=f"KrakenUniq-TPU-torch version {__version__}")
    p.add_argument("files", nargs="*", help="FASTA/FASTQ input files (gz/bz2/xz ok)")
    return p


def parse_size(s: str) -> int:
    """Parse a byte size with an optional K/M/G/T suffix (powers of 1024,
    the reference's --preload-size grammar, scripts/krakenuniq)."""
    s = s.strip().upper().rstrip("B")
    mult = 1
    if s and s[-1] in "KMGT":
        mult = 1024 ** ("KMGT".index(s[-1]) + 1)
        s = s[:-1]
    return int(float(s) * mult)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)

    from ..classify import Classifier, ClassifyOptions
    from ..formats.seqio import merge_paired, open_output
    from ..taxonomy import Taxonomy

    if not args.db:
        print("Need to specify a database with --db!", file=sys.stderr)
        return 1
    if not args.files and not args.preload:
        print("Need to specify input filenames!", file=sys.stderr)
        return 1
    if args.min_hits > 1 and not args.quick:
        print("--min-hits requires --quick to be specified", file=sys.stderr)
        return 1
    if args.paired and len(args.files) != 2:
        print("--paired requires exactly two filenames", file=sys.stderr)
        return 1
    if args.gzip_compressed or args.bzip2_compressed:
        print("NOTE: compression is detected automatically.", file=sys.stderr)
    if args.fasta_input or args.fastq_input:
        print("NOTE: input format is detected automatically.", file=sys.stderr)

    try:
        db_dirs = [find_db(d) for d in args.db]
    except ValueError as e:
        print(f"krakenuniq-tpu-torch: {e}", file=sys.stderr)
        return 1
    # write taxDB from the NCBI dumps when it is missing (scripts/krakenuniq:213-221)
    taxdb_path = os.path.join(db_dirs[0], "taxDB")
    if not os.path.exists(taxdb_path):
        nodes = os.path.join(db_dirs[0], "taxonomy", "nodes.dmp")
        names = os.path.join(db_dirs[0], "taxonomy", "names.dmp")
        if not (os.path.exists(nodes) and os.path.exists(names)):
            print(f"{taxdb_path} missing and taxonomy dumps not found", file=sys.stderr)
            return 1
        print(f"Taxonomy database not at {taxdb_path} - creating it ...", file=sys.stderr)
        Taxonomy.from_ncbi_dumps(names, nodes).write_taxdb(taxdb_path)

    preload_size = None
    if args.preload_size:
        try:
            preload_size = parse_size(args.preload_size)
        except ValueError:
            print(f"bad --preload-size value {args.preload_size!r}", file=sys.stderr)
            return 1

    opts = ClassifyOptions(
        quick=args.quick,
        min_hits=args.min_hits,
        hll_precision=args.hll_precision,
        exact=args.exact,
        only_classified_output=args.only_classified_output,
        print_sequence=args.print_sequence,
        full_report=args.full_report,
        device_counters=args.device_counters,
        device=args.device,
        preload_size=preload_size,
    )

    inputs = list(args.files)
    tmp_merged = None
    if args.paired:
        fd, tmp_merged = tempfile.mkstemp(suffix=".merged.fa")
        with os.fdopen(fd, "w") as fh:
            merge_paired(inputs[0], inputs[1], fh, check_names=args.check_names)
        inputs = [tmp_merged]

    # report provenance header (scripts/krakenuniq:242-247)
    if args.report_file and args.report_file != "off":
        date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        db_size = os.path.getsize(os.path.join(db_dirs[0], "database.kdb"))
        cl = " ".join([sys.argv[0]] + [shlex.quote(a) for a in argv])
        os.makedirs(os.path.dirname(os.path.abspath(args.report_file)), exist_ok=True)
        with open(args.report_file, "w") as rf:
            rf.write(
                f"# KrakenUniq-TPU-torch v{__version__} DATE:{date} DB:{' '.join(db_dirs)} "
                f"DB_SIZE:{db_size} WD:{os.getcwd()}\n# CL:{cl}\n"
            )

    close_fhs = []
    try:
        classifier = Classifier(db_dirs, options=opts, uid_database=args.uid_mapping)
        kraken_fh = None
        if args.output != "off":
            if args.output in (None, "-"):
                kraken_fh = sys.stdout
            else:
                kraken_fh = open_output(args.output)
                close_fhs.append(kraken_fh)
                print(f"Writing Kraken output to {args.output}", file=sys.stderr)
        classified_fh = unclassified_fh = None
        if args.classified_out:
            classified_fh = open_output(args.classified_out)
            close_fhs.append(classified_fh)
        if args.unclassified_out:
            unclassified_fh = open_output(args.unclassified_out)
            close_fhs.append(unclassified_fh)
        classifier.run(
            inputs,
            kraken_fh=kraken_fh,
            classified_fh=classified_fh,
            unclassified_fh=unclassified_fh,
        )
        classifier.report_stats()
        if args.report_file and args.report_file != "off":
            print(f"Writing report file to {args.report_file}  ..", file=sys.stderr)
            with open(args.report_file, "a") as rf:
                classifier.write_report(rf)
    finally:
        for fh in close_fhs:
            fh.close()
        if tmp_merged:
            os.unlink(tmp_merged)
    print("Finishing up ...", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
