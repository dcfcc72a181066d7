"""`krakenuniq-tpu-torch-build` -- database construction CLI, flag-compatible with
the reference `krakenuniq-build` / build_db.sh pipeline (6 restartable
steps; steps already done are skipped via output-file existence, matching
build_db.sh:116-304).

Run it as `python -m krakenuniq_tpu_torch.cli.build_main --db DIR ...`. The
steps before 6b are host numpy and the native scanner; step 6b classifies
the library through the port's classify CLI on `--device` (default `cuda`,
as the classify CLI's; `cpu` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys

from .. import __version__

LIBRARY_EXTS = (".fna", ".fa", ".ffn", ".fasta", ".fsa", ".fna.gz", ".fa.gz", ".fasta.gz")


def find_library_files(library_dirs: list[str]):
    fastas, maps = [], []
    for d in library_dirs:
        for root, _, files in os.walk(d):
            for f in sorted(files):
                p = os.path.join(root, f)
                if f.endswith(".map"):
                    maps.append(p)
                elif any(f.endswith(e) for e in LIBRARY_EXTS):
                    fastas.append(p)
    return sorted(fastas), sorted(maps)


def build_parser():
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-build")
    p.add_argument("--db", required=True, help="database directory")
    p.add_argument("--kmer-len", type=int, default=31)
    p.add_argument("--minimizer-len", type=int, default=15)
    p.add_argument("--threads", type=int, default=1, help="accepted for compatibility")
    p.add_argument("--build", action="store_true", help="(default task)")
    p.add_argument(
        "--standard",
        action="store_true",
        help="download taxonomy+contaminants+refseq bacteria/archaea/viral and build "
        "(krakenuniq-build:357 standard_installation)",
    )
    p.add_argument(
        "--download-taxonomy",
        action="store_true",
        help="download NCBI taxonomy into <db>/taxonomy",
    )
    p.add_argument(
        "--download-library",
        metavar="TYPE",
        help="download a library (e.g. refseq/bacteria, viral-neighbors, contaminants) "
        "into <db>/library",
    )
    p.add_argument("--rebuild", action="store_true", help="remove products first")
    p.add_argument("--clean", action="store_true", help="remove intermediate files")
    p.add_argument("--add-to-library", metavar="FILE", help="copy FILE into library/added/")
    p.add_argument("--taxids-for-genomes", action="store_true")
    p.add_argument("--taxids-for-sequences", action="store_true")
    p.add_argument("--min-contig-size", type=int, default=0)
    p.add_argument("--max-db-size", type=float, default=None, help="maximum database size in GB (down-samples k-mers)")
    p.add_argument("--shrink", type=int, default=None, metavar="N", help="shrink existing DB to N k-mers")
    p.add_argument("--shrink-block-offset", type=int, default=1)
    p.add_argument(
        "--new-db",
        metavar="NAME",
        default=None,
        help="new database name (shrink task only; mandatory for that task, "
        "krakenuniq-build:268,351-353)",
    )
    p.add_argument(
        "--upgrade",
        action="store_true",
        help="upgrade a pre-v0.10 DB (v1 plain-minimizer index) to the v2 "
        "XOR-scrambled order (upgrade_db.sh)",
    )
    p.add_argument(
        "--reset-taxids",
        action="store_true",
        help="re-run LCA value assignment even if database.kdb exists "
        "(KRAKEN_RESET_TAXIDS, build_db.sh:244)",
    )
    p.add_argument(
        "--verbose",
        action="store_true",
        help="per-bucket progress from the streaming build (the reference "
        "computes its -x opt but never passes it, krakenuniq-build:396-397)",
    )
    p.add_argument(
        "--build-memory",
        default="1G",
        metavar="SIZE",
        help="RAM budget for the streaming LCA build (pair buckets are "
        "sized to fit; K/M/G suffixes)",
    )
    p.add_argument("--work-on-disk", action="store_true", help="accepted no-op")
    p.add_argument("--jellyfish-hash-size", help="accepted no-op (no Jellyfish needed)")
    p.add_argument("--jellyfish-bin", help="accepted no-op")
    p.add_argument("--library-dir", action="append", default=[])
    p.add_argument("--taxonomy-dir", default=None)
    p.add_argument("--uid-database", action="store_true")
    p.add_argument("--lca-order", action="append", default=[])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where step 6b's self-classification runs (default: cuda)")
    p.add_argument("--version", action="version", version=f"KrakenUniq-TPU-torch version {__version__}")
    return p


def _log_step(db: str, msg: str) -> None:
    """Append a timestamped line to <db>/database-build.log, the reference's
    build log format (build_db.sh:43-47: `date "+%Y-%m-%d %H:%M:%S"\\tCMD`)."""
    import datetime

    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(db, "database-build.log"), "a") as f:
        f.write(f"{stamp}\t{msg}\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    db = args.db
    os.makedirs(db, exist_ok=True)

    # task dispatch, mirroring krakenuniq-build:128-135's one-task-per-run
    # elsif chain: download tasks run and exit; --standard chains downloads
    # into a build (standard_installation, krakenuniq-build:357-364).
    if args.download_taxonomy or args.download_library or args.standard:
        from .download_main import main as download_main

        if args.download_taxonomy:
            _log_step(db, f"krakenuniq-tpu-torch-download --db {db} taxonomy")
            return download_main(["--db", db, "taxonomy"])
        if args.download_library:
            _log_step(db, f"krakenuniq-tpu-torch-download --db {db} {args.download_library}")
            return download_main(["--db", db, args.download_library])
        # --standard
        for patterns in (
            ["taxonomy", "contaminants"],
            ["refseq/archaea", "refseq/bacteria", "refseq/viral/Any", "viral-neighbors"],
        ):
            cmd = ["--db", db] + patterns
            print(f"krakenuniq-tpu-torch-download {' '.join(cmd)}", file=sys.stderr)
            _log_step(db, f"krakenuniq-tpu-torch-download {' '.join(cmd)}")
            rc = download_main(cmd)
            if rc != 0:
                return rc
        # fall through to the build

    if args.upgrade:
        # task: upgrade_database (krakenuniq-build:229-230,404-405 ->
        # upgrade_db.sh): re-sort a pre-v0.10 DB to scrambled minimizer order
        from .tools import upgrade_db_main

        _log_step(db, "upgrade_db (v1 -> v2 scrambled minimizer order)")
        return upgrade_db_main([db])

    if args.add_to_library:
        dest = os.path.join(db, "library", "added")
        os.makedirs(dest, exist_ok=True)
        shutil.copy(args.add_to_library, dest)
        print(f"Added {args.add_to_library} to library ({dest})", file=sys.stderr)
        return 0

    if args.clean:
        for name in ("database.jdb", "database0.kdb", "seqid2taxid-plus.map", "library-files.fa"):
            p = os.path.join(db, name)
            if os.path.exists(p):
                os.remove(p)
        print("Cleaned intermediate files.", file=sys.stderr)
        return 0


    if args.rebuild:
        # step-6b products must go too: their existence gates regeneration,
        # and a stale self-classification describes the OLD database
        for name in ("database.kdb", "database.idx", "database.kdb.counts",
                     "taxDB", "database.report.tsv", "database.kraken.tsv"):
            p = os.path.join(db, name)
            if os.path.exists(p):
                os.remove(p)

    from ..build.db_build import expand_dynamic_taxids, shrink_pairs
    from ..formats import read_kdb, write_kdb, write_index
    from ..formats.counts import counts_from_vals, write_counts
    from ..taxonomy import Taxonomy
    from ..utils.bits import bin_key
    import numpy as np

    kdb_path = os.path.join(db, "database.kdb")
    idx_path = os.path.join(db, "database.idx")
    taxdb_path = os.path.join(db, "taxDB")

    if args.shrink is not None:
        # shrink task semantics: N must be positive and the target database
        # name is mandatory and must not already exist (krakenuniq-build:
        # 348-354, shrink_db.sh:33-40)
        if args.shrink <= 0:
            print("New DB must have at least 1 k-mer", file=sys.stderr)
            return 64
        if not args.new_db:
            print(
                "Must specify new database name (--new-db) to perform shrink task",
                file=sys.stderr,
            )
            return 64
        out_dir = args.new_db
        if os.path.exists(out_dir):
            print(
                f"{args.new_db} already exists ({out_dir}), aborting shrink operation.",
                file=sys.stderr,
            )
            return 1
        hdr, keys, vals = read_kdb(kdb_path)
        keys, vals = shrink_pairs(keys, vals, args.shrink, args.shrink_block_offset)
        b = bin_key(keys, hdr.k, args.minimizer_len)
        order = np.lexsort((keys, b))
        keys, vals, b = keys[order], vals[order], b[order]
        counts = np.bincount(b.astype(np.int64), minlength=4**args.minimizer_len)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
        os.makedirs(out_dir)
        write_kdb(os.path.join(out_dir, "database.kdb"), keys, vals, k=hdr.k)
        write_index(os.path.join(out_dir, "database.idx"), args.minimizer_len, offsets)
        # shrink_db.sh:42-43 seeds the new DB's taxonomy from the old one;
        # copying taxDB too saves the new DB a rebuild from dumps
        old_tax = os.path.join(db, "taxonomy")
        if os.path.isdir(old_tax):
            new_tax = os.path.join(out_dir, "taxonomy")
            os.makedirs(new_tax, exist_ok=True)
            for dump in ("nodes.dmp", "names.dmp"):
                src = os.path.join(old_tax, dump)
                if os.path.exists(src):
                    shutil.copy(src, new_tax)
        if os.path.exists(taxdb_path):
            shutil.copy(taxdb_path, os.path.join(out_dir, "taxDB"))
        print(f"Shrunk database written to {out_dir}", file=sys.stderr)
        return 0

    if not (2 < args.kmer_len <= 31):
        print("kmer-len must be in (2, 31]", file=sys.stderr)
        return 64
    if not (0 < args.minimizer_len < args.kmer_len):
        print("minimizer-len must be positive and smaller than kmer-len", file=sys.stderr)
        return 64

    library_dirs = args.library_dir or [os.path.join(db, "library")]
    tax_dir = args.taxonomy_dir or os.path.join(db, "taxonomy")

    # step: taxDB from dumps (build_db.sh:224-241)
    if os.path.exists(taxdb_path) and os.path.getsize(taxdb_path) > 0:
        print("taxDB present, skipping taxonomy step", file=sys.stderr)
        taxonomy = Taxonomy.from_taxdb_file(taxdb_path)
    else:
        nodes = os.path.join(tax_dir, "nodes.dmp")
        names = os.path.join(tax_dir, "names.dmp")
        if not os.path.exists(nodes):
            print(f"no taxDB and no taxonomy dumps at {tax_dir}", file=sys.stderr)
            return 1
        print("Building taxDB from taxonomy dumps...", file=sys.stderr)
        _log_step(db, f"build_taxdb {names} {nodes} > taxDB")
        taxonomy = Taxonomy.from_ncbi_dumps(names, nodes)
        taxonomy.write_taxdb(taxdb_path)

    # step: seqid2taxid.map (build_db.sh:211-221)
    map_path = os.path.join(db, "seqid2taxid.map")
    fastas, maps = find_library_files(library_dirs)
    if not os.path.exists(map_path):
        if not maps:
            print("no .map files found in library dirs", file=sys.stderr)
            return 1
        _log_step(db, f"cat {len(maps)} library .map files > seqid2taxid.map")
        with open(map_path, "w") as out:
            for m in maps:
                with open(m) as f:
                    out.write(f.read())

    map_lines: list[tuple[str, int, str]] = []
    with open(map_path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= 2:
                rest = fields[2] if len(fields) > 2 else ""
                map_lines.append((fields[0], int(fields[1]), rest))

    if args.taxids_for_genomes or args.taxids_for_sequences:
        taxonomy, seqmap = expand_dynamic_taxids(
            taxonomy,
            map_lines,
            for_assembly=args.taxids_for_genomes,
            for_sequences=args.taxids_for_sequences,
        )
        taxonomy.write_taxdb(taxdb_path)
        with open(map_path, "w") as f:
            for seqid, taxid in seqmap.items():
                f.write(f"{seqid}\t{taxid}\n")
    else:
        seqmap = {seqid: taxid for seqid, taxid, _ in map_lines}

    # step: build LCA database (build_db.sh steps 1-3 + 6 in one pass).
    # --reset-taxids re-runs it over an existing database.kdb (build_db.sh:
    # 244 skips step 6 only when kdb exists AND KRAKEN_RESET_TAXIDS != 1);
    # here values are recomputed from the library in the same streaming
    # pass that writes the k-mer set, so a reset is a full re-run, and the
    # products derived from the old values must go first.
    if args.reset_taxids:
        for name in ("database.kdb.counts", "database.report.tsv",
                     "database.kraken.tsv"):
            p = os.path.join(db, name)
            if os.path.exists(p):
                os.remove(p)
    if (
        os.path.exists(kdb_path)
        and os.path.getsize(kdb_path) > 0
        and not args.reset_taxids
    ):
        print("database.kdb present, skipping build step", file=sys.stderr)
        _, _, vals = read_kdb(kdb_path)
    else:
        if not fastas:
            print("no library FASTA files found", file=sys.stderr)
            return 1
        print(f"Building database from {len(fastas)} library files "
              f"(k={args.kmer_len}, minimizer={args.minimizer_len})...", file=sys.stderr)
        _log_step(
            db,
            f"build_database k={args.kmer_len} nt={args.minimizer_len} "
            f"({len(fastas)} library files)",
        )
        max_kmers = None
        if args.max_db_size:
            pair_size = (2 * args.kmer_len) // 8 + (1 if (2 * args.kmer_len) % 8 else 0) + 4
            max_kmers = int(args.max_db_size * (1 << 30) / pair_size)
        lca_groups = None
        if args.lca_order:
            lca_groups = []
            for part in args.lca_order:
                for name in part.split(";"):
                    group = [f for f in fastas if f"/{name}/" in f or f.endswith(f"/{name}")
                             or os.path.basename(os.path.dirname(f)) == name]
                    if not group:
                        print(f"--lca-order: no library files match {name}", file=sys.stderr)
                        return 1
                    lca_groups.append(group)
        from ..build.db_build import stream_database_to_dir
        from .main import parse_size

        stats = stream_database_to_dir(
            db,
            fastas,
            seqmap,
            taxonomy,
            k=args.kmer_len,
            nt=args.minimizer_len,
            min_sequence_size=args.min_contig_size,
            max_kmers=max_kmers,
            lca_order=lca_groups,
            memory_budget=parse_size(args.build_memory),
            verbose=args.verbose,
        )
        print(
            f"LCA database created: {stats['key_ct']} k-mers in "
            f"{stats['seconds']}s ({stats['keys_per_s']}/s, "
            f"budget {stats['memory_budget'] >> 20} MB)",
            file=sys.stderr,
        )
        _log_step(db, f"database.kdb written ({stats['key_ct']} k-mers)")
        vals = None

    counts_path = kdb_path + ".counts"
    if not os.path.exists(counts_path):
        if vals is None:
            _, _, vals = read_kdb(kdb_path)
        write_counts(counts_path, counts_from_vals(vals))

    # step 6b: self-classify the library into a database summary report
    # (build_db.sh:305-312: krakenuniq --preload --db . --report-file
    # database.report.tsv library-files.fa > database.kraken.tsv). The
    # library files feed the classifier directly -- no library-files.fa
    # concatenation step is needed.
    report_path = os.path.join(db, "database.report.tsv")
    if fastas and not (
        os.path.exists(report_path) and os.path.getsize(report_path) > 0
    ):
        from .main import main as classify_main

        print(
            f"Creating database summary report {os.path.basename(report_path)} ...",
            file=sys.stderr,
        )
        _log_step(
            db,
            f"krakenuniq-tpu-torch --preload --db {db} --report-file {report_path} "
            f"[{len(fastas)} library files] > database.kraken.tsv",
        )
        # the classify CLI writes the report's header before it loads the
        # database: a run that fails leaves no report behind, or the rerun
        # would take the header alone for a finished step
        rc = 1
        try:
            rc = classify_main(
                [
                    "--db", db,
                    "--preload",
                    "--report-file", report_path,
                    "--output", os.path.join(db, "database.kraken.tsv"),
                    "--device", args.device,
                ]
                + list(fastas)
            )
        finally:
            if rc != 0 and os.path.exists(report_path):
                os.remove(report_path)
        if rc != 0:
            print("database summary report failed", file=sys.stderr)
            return rc

    # optional UID database (build_db.sh:316-348)
    uid_kdb = os.path.join(db, "uid_database.kdb")
    if args.uid_database and not os.path.exists(uid_kdb):
        from ..build.uid_build import build_uid_database
        from ..formats import read_index

        hdr, keys, _ = read_kdb(kdb_path)
        _, nt_idx, offsets = read_index(idx_path)
        print("Building UID database...", file=sys.stderr)
        _log_step(db, "build_uid_database (set_lcas -I equivalent)")
        build_uid_database(fastas, seqmap, keys, hdr.k, nt_idx, offsets, db)

    _log_step(db, "database build complete")
    print("Database build complete.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
