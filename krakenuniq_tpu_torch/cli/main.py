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

`--mesh DATAxDB` spawns DATA * DB ranks of its own (parallel/mesh.py): the
tables minimizer-sharded over DB ranks, each span's rows over DATA ranks,
rank 0 writing the outputs; ranks share the cards round-robin and talk over
gloo when they share one (NCCL when each has its own). `--multihost ID/N`
classifies this host's share of the spans (s % N == ID) and, with the
default auto collect, host 0 merges every host's output and counter state
(parallel/multihost.py); the flags, messages and exit codes are the JAX
package's (krakenuniq_tpu/cli/main.py:76-138, 197-242, 257-440).
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
    p.add_argument(
        "--mesh",
        default=None,
        metavar="DATAxDB",
        help="a mesh of DATA*DB spawned ranks, e.g. 2x4: shard the database by minimizer range over DB "
        "ranks and each span's reads over DATA ranks (ranks share the cards round-robin; gloo when "
        "they share a card, NCCL when each has its own)",
    )
    p.add_argument(
        "--multihost",
        default=None,
        metavar="ID/N",
        help="multi-host input sharding (parallel/multihost.py): this process is host ID of N; it "
        "classifies the global spans with span %% N == ID. By default (--multihost-collect auto) run "
        "the SAME command on every host over a shared filesystem: each host writes <output>.part<ID> "
        "(+ .manifest) and counter state <report>.state.<ID>, then host 0 waits for its peers and merges "
        "the kraken segments into <output> and every host's counter state into the final report",
    )
    p.add_argument(
        "--multihost-collect",
        choices=("auto", "off"),
        default="auto",
        help="auto (default): host 0 rendezvouses on per-host .done markers and performs the full merge "
        "itself. off: every host writes its own segment to its --output plus a manifest, and only the "
        "report counter-states are mergeable -- concatenate kraken segments with "
        "parallel.multihost.merge_kraken_outputs over the manifests, and fold states into host 0's "
        "report via --multihost-merge",
    )
    p.add_argument(
        "--multihost-wait",
        type=float,
        default=3600.0,
        metavar="SECONDS",
        help="how long host 0 waits for peer .done markers in auto-collect mode before failing",
    )
    p.add_argument(
        "--multihost-recover",
        choices=("auto", "off"),
        default="auto",
        help="auto (default): when host 0's rendezvous times out, re-run each lost host's span share "
        "in-process (artifacts are idempotent; span ownership is deterministic), then complete the "
        "merge. off: fail with the list of lost hosts and the recovery command",
    )
    p.add_argument(
        "--multihost-merge",
        action="append",
        default=[],
        metavar="STATEFILE",
        help="fold other hosts' counter-state files into this host's report (manual flow, "
        "--multihost-collect off)",
    )
    p.add_argument(
        "--distributed-init",
        default=None,
        metavar="COORD_ADDR",
        help="bring up torch.distributed against this coordinator (tcp://host:port; "
        "KUNIQ_NUM_PROCS/KUNIQ_PROC_ID or --multihost supply the ids)",
    )
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

    from ..classify import ClassifyOptions
    from ..formats.seqio import merge_paired
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

    mesh_data = mesh_db = 1
    if args.mesh:
        try:
            mesh_data, mesh_db = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            print(f"--mesh expects DATAxDB (e.g. 2x4), got {args.mesh!r}", file=sys.stderr)
            return 1

    preload_size = None
    if args.preload_size:
        try:
            preload_size = parse_size(args.preload_size)
        except ValueError:
            print(f"bad --preload-size value {args.preload_size!r}", file=sys.stderr)
            return 1

    host_id, n_hosts = 0, 1
    if args.multihost:
        try:
            host_id, n_hosts = (int(x) for x in args.multihost.split("/"))
        except ValueError:
            print(f"--multihost expects ID/N (e.g. 0/2), got {args.multihost!r}", file=sys.stderr)
            return 1
    if args.distributed_init:
        from ..parallel.multihost import initialize

        initialize(
            args.distributed_init,
            num_processes=n_hosts if args.multihost else None,
            process_id=host_id if args.multihost else None,
            platform=args.device,
        )

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
        mesh_data=mesh_data,
        mesh_db=mesh_db,
        host_id=host_id,
        n_hosts=n_hosts,
    )

    inputs = list(args.files)
    tmp_merged = None
    if args.paired:
        fd, tmp_merged = tempfile.mkstemp(suffix=".merged.fa")
        with os.fdopen(fd, "w") as fh:
            merge_paired(inputs[0], inputs[1], fh, check_names=args.check_names)
        inputs = [tmp_merged]

    # auto-collect (multi-host): every host runs this same command; kraken
    # segments land in <output>.part<ID>, and host 0 rendezvouses on peer
    # .done markers (shared filesystem) before merging everything itself
    auto_collect = n_hosts > 1 and args.multihost_collect == "auto" and args.output not in (None, "-", "off")
    kraken_path = args.output
    if auto_collect:
        kraken_path = f"{args.output}.part{host_id}"
        try:  # a stale marker must not satisfy a concurrent rendezvous
            os.unlink(f"{args.output}.done{host_id}")
        except OSError:
            pass

    # report provenance header (scripts/krakenuniq:242-247); under
    # auto-collect only host 0 owns the (shared) report file
    if args.report_file and args.report_file != "off" and not (auto_collect and host_id != 0):
        date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        db_size = os.path.getsize(os.path.join(db_dirs[0], "database.kdb"))
        cl = " ".join([sys.argv[0]] + [shlex.quote(a) for a in argv])
        os.makedirs(os.path.dirname(os.path.abspath(args.report_file)), exist_ok=True)
        with open(args.report_file, "w") as rf:
            rf.write(
                f"# KrakenUniq-TPU-torch v{__version__} DATE:{date} DB:{' '.join(db_dirs)} "
                f"DB_SIZE:{db_size} WD:{os.getcwd()}\n# CL:{cl}\n"
            )

    run = (args, db_dirs, opts, inputs, kraken_path, auto_collect)
    try:
        if mesh_data * mesh_db > 1:
            from ..parallel.mesh import spawn_mesh

            rc = spawn_mesh(_classify_rank, mesh_data, mesh_db, args.device, args=run)
        else:
            rc = _classify(*run)
    finally:
        if tmp_merged:
            os.unlink(tmp_merged)
    if rc == 0:
        print("Finishing up ...", file=sys.stderr)
    return rc


def _classify_rank(mesh, *run) -> int | None:
    """One rank of a --mesh run (parallel/mesh.spawn_mesh)."""
    return _classify(*run, mesh=mesh)


def _classify(args, db_dirs, opts, inputs, kraken_path, auto_collect, mesh=None) -> int:
    """Classify, write the outputs and, multi-host, the host's artifacts and
    the merge. Under a mesh every rank classifies and rank 0 alone writes."""
    import dataclasses
    import json

    from ..classify import Classifier
    from ..formats.seqio import open_output

    root = mesh is None or mesh.is_root
    host_id, n_hosts = opts.host_id, opts.n_hosts
    if not root:
        opts = dataclasses.replace(opts, print_progress=False)
    classifier = Classifier(db_dirs, options=opts, uid_database=args.uid_mapping)
    if not root:
        classifier.run(inputs)
        return None
    close_fhs = []
    try:
        kraken_fh = None
        if args.output != "off":
            if args.output in (None, "-"):
                kraken_fh = sys.stdout
            else:
                kraken_fh = open_output(kraken_path)
                close_fhs.append(kraken_fh)
                print(f"Writing Kraken output to {kraken_path}", file=sys.stderr)
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
        report_on = bool(args.report_file) and args.report_file != "off"
        extra_counts = list(args.multihost_merge) or None
        if n_hosts > 1:
            # cross-host artifacts (parallel/multihost.py): the kraken span
            # manifest and this host's counter state -- the reference's
            # per-worker temp-file merge made explicit (classify.cpp:390-485)
            from ..parallel.multihost import MultihostTimeout, rendezvous_and_merge, save_counter_state

            if args.output and args.output not in ("off", "-"):
                with open(kraken_path + ".manifest", "w") as mf:
                    json.dump(classifier.span_manifest, mf)
            if report_on:
                save_counter_state(f"{args.report_file}.state.{host_id}", classifier.finalized_counts())
            if auto_collect:
                for fh in close_fhs:
                    fh.close()
                close_fhs = []
                report_arg = args.report_file if report_on else None
                try:
                    done = rendezvous_and_merge(host_id, n_hosts, output=args.output, report_file=report_arg,
                                                timeout=args.multihost_wait)
                except MultihostTimeout as e:
                    print(str(e), file=sys.stderr)
                    if args.multihost_recover != "auto":
                        return 75  # EX_TEMPFAIL: lost hosts listed above
                    if not _recover(e, args, db_dirs, opts, inputs, report_arg, classified_fh, unclassified_fh):
                        return 75
                    done = rendezvous_and_merge(host_id, n_hosts, output=args.output, report_file=report_arg,
                                                timeout=args.multihost_wait)
                if host_id != 0:
                    # peers are finished once their marker is down; host 0
                    # owns the merged kraken output and the report
                    return 0
                extra_counts = done or None
        if report_on:
            print(f"Writing report file to {args.report_file}  ..", file=sys.stderr)
            with open(args.report_file, "a") as rf:
                classifier.write_report(rf, extra_counts=extra_counts)
    finally:
        for fh in close_fhs:
            fh.close()
    return 0


def _recover(e, args, db_dirs, opts, inputs, report_arg, classified_fh, unclassified_fh) -> bool:
    """Re-run each lost host's span share in this process (JAX cli/main.py:
    335-411): span ownership is s % n_hosts == ID, so a Classifier with the
    lost host's id reproduces its artifacts byte for byte (the
    idempotent-artifact pattern, build_db.sh:116); on one device, whatever
    this host's mesh. False when an input cannot be read again."""
    import dataclasses
    import json
    import stat

    from ..classify import Classifier
    from ..formats.seqio import open_output
    from ..parallel.multihost import save_counter_state, write_done_marker

    # a pipe / FIFO / stdin was consumed by this host's own pass and would
    # silently yield zero reads for the lost share
    for inp in inputs:
        try:
            st = os.stat(inp)
        except OSError:
            st = None
        if st is None or not stat.S_ISREG(st.st_mode):
            print(f"Cannot auto-recover: input {inp!r} is not a re-readable regular file. Re-run the lost "
                  "hosts' shares manually.", file=sys.stderr)
            return False
    for lost in e.missing_hosts:
        # a slow-but-alive peer may have finished during the timeout window
        # -- its artifacts win
        if os.path.exists(f"{args.output}.done{lost}"):
            print(f"Host {lost} completed late; skipping recovery for it.", file=sys.stderr)
            continue
        print(f"Recovering lost host {lost}'s span share in-process ...", file=sys.stderr)
        r_opts = dataclasses.replace(opts, host_id=lost, mesh_data=1, mesh_db=1)
        rcl = Classifier(db_dirs, options=r_opts, uid_database=args.uid_mapping)
        # temp paths renamed into place: a peer alive after all lands on
        # another inode, and the rename publishes one whole artifact
        part = f"{args.output}.part{lost}"
        pfh = open_output(part + ".recover")
        try:
            rcl.run(inputs, kraken_fh=pfh, classified_fh=classified_fh, unclassified_fh=unclassified_fh)
        finally:
            pfh.close()
        with open(part + ".manifest.recover", "w") as mf:
            json.dump(rcl.span_manifest, mf)
        if report_arg:
            save_counter_state(f"{report_arg}.state.{lost}", rcl.finalized_counts())
        os.replace(part + ".recover", part)
        os.replace(part + ".manifest.recover", part + ".manifest")
        write_done_marker(args.output, lost)
    return True


if __name__ == "__main__":
    sys.exit(main())
