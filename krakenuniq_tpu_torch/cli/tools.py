"""CLI entry points for the post-processing tools, flag-compatible with the
reference's krakenuniq-report / -translate / -filter / -mpa-report /
-extract-reads scripts."""

from __future__ import annotations

import argparse
import sys

from .dblib import find_db


def report_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-report")
    p.add_argument("--db", required=False)
    p.add_argument("--show-zeros", action="store_true")
    p.add_argument("--taxon-counts", action="store_true")
    p.add_argument("--taxon-list", action="store_true")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    if a.taxon_counts and a.taxon_list:
        print("Specify either --taxon-counts or --taxon-list, not both!", file=sys.stderr)
        return 64
    mode = "taxon-counts" if a.taxon_counts else "taxon-list" if a.taxon_list else "kraken"
    from ..report.postprocess import basic_report

    basic_report(find_db(a.db), a.files, sys.stdout, show_zeros=a.show_zeros, mode=mode)
    return 0


def translate_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-translate")
    p.add_argument("--db", required=False)
    p.add_argument("--mpa-format", action="store_true")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    from ..report.postprocess import translate

    translate(find_db(a.db), a.files, sys.stdout, mpa_format=a.mpa_format)
    return 0


def filter_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-filter")
    p.add_argument("--db", required=False)
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    if not 0 <= a.threshold <= 1:
        print("threshold must be in the interval [0,1].", file=sys.stderr)
        return 64
    from ..report.postprocess import filter_output

    filter_output(find_db(a.db), a.files, sys.stdout, threshold=a.threshold)
    return 0


def mpa_report_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-mpa-report")
    p.add_argument("--db", required=False)
    p.add_argument("--show-zeros", action="store_true")
    p.add_argument("--header-line", action="store_true")
    p.add_argument("--intermediate-ranks", action="store_true")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    from ..report.postprocess import mpa_report

    mpa_report(
        find_db(a.db),
        a.files,
        sys.stdout,
        show_zeros=a.show_zeros,
        header_line=a.header_line,
        intermediate_ranks=a.intermediate_ranks,
    )
    return 0


def extract_reads_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-extract-reads")
    p.add_argument("-a", dest="fasta_input", action="store_true", help="input is FASTA")
    p.add_argument("-f", dest="fasta_output", action="store_true", help="output FASTA")
    p.add_argument("-i", dest="invert", action="store_true")
    p.add_argument("-p", dest="paired", action="store_true")
    p.add_argument("-t", dest="taxdb", default=None, help="taxDB for subtree expansion")
    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("taxon", help="taxid(s), comma separated")
    p.add_argument("kraken")
    p.add_argument("seqfile")
    a = p.parse_args(argv)
    from ..report.extract_reads import extract_reads

    extract_reads(
        [int(t) for t in a.taxon.split(",")],
        a.kraken,
        a.seqfile,
        sys.stdout,
        fasta_input=a.fasta_input,
        fasta_output=a.fasta_output,
        invert=a.invert,
        taxdb_path=a.taxdb,
        paired=a.paired,
    )
    return 0


def dump_taxdb_main(argv=None) -> int:
    """taxDB -> names.dmp + nodes.dmp round trip (dump_taxdb.cpp:27-56),
    emitted in sorted-taxid order (the reference's hash order is arbitrary)."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-dump-taxdb")
    p.add_argument("taxdb")
    p.add_argument("names_dmp")
    p.add_argument("nodes_dmp")
    a = p.parse_args(argv)
    from ..taxonomy import Taxonomy

    tax = Taxonomy.from_taxdb_file(a.taxdb)
    import numpy as np

    with open(a.nodes_dmp, "w") as nodes, open(a.names_dmp, "w") as names:
        for i in np.argsort(tax.taxids, kind="stable"):
            t = int(tax.taxids[i])
            if t == 0:
                continue
            parent = int(tax.taxids[tax.parent[i]])
            nodes.write(f"{t}\t|\t{parent}\t|\t{tax.ranks[i]}\n")
            names.write(f"{t}\t|\t{tax.names[i]}\t|\t\t|\tscientific name\n")
    return 0


def query_taxdb_main(argv=None) -> int:
    """Lineage queries against a taxDB (query_taxdb.cpp:48-77)."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-query-taxdb")
    p.add_argument("-L", dest="lineage", action="store_true", help="print MetaPhlAn lineage (default)")
    p.add_argument("taxdb")
    p.add_argument("taxids", nargs="*")
    a = p.parse_args(argv)
    from ..taxonomy import Taxonomy

    tax = Taxonomy.from_taxdb_file(a.taxdb)

    def emit(taxid: int):
        print(f"{taxid}\t{tax.metaphlan_lineage(taxid)}")

    for t in a.taxids:
        emit(int(t))
    if not sys.stdin.isatty() and not a.taxids:
        for line in sys.stdin:
            for t in line.split():
                emit(int(t))
    return 0


def dump_db_kmers_main(argv=None) -> int:
    """Dump database k-mers as 64-bit numbers, one per line.

    NOTE: intentionally NOT bug-compatible -- the reference tool
    (dump_db_kmers.cpp:45-59) reads from the file start instead of past the
    header, emitting header bytes and misaligned pairs. This version dumps
    the actual keys."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-dump-db-kmers")
    p.add_argument("database")
    a = p.parse_args(argv)
    from ..formats import read_kdb

    _, keys, _ = read_kdb(a.database)
    w = sys.stdout
    for v in keys.tolist():
        w.write(f"{v}\n")
    return 0


def count_unique_main(argv=None) -> int:
    """Estimate distinct k-mers on stdin FASTA via HLL (count_unique.cpp:51-81;
    non-canonical k-mers, per-block dense counters merged)."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-count-unique")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-p", dest="precision", type=int, default=14)
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-m", dest="minimizer", type=int, default=None, help="accepted no-op")
    a = p.parse_args(argv)
    import numpy as np

    from ..formats.seqio import read_fasta
    from ..hll import HLL
    from ..kmer.encode import BASE_CODE_TABLE, AMBIG_TABLE

    counter = HLL(a.precision, sparse=True)
    for dna in read_fasta(sys.stdin):
        seq = np.frombuffer(dna.seq.encode(), np.uint8)
        if len(seq) < a.k:
            continue
        codes = BASE_CODE_TABLE[seq].astype(np.uint64)
        ambig = AMBIG_TABLE[seq]
        n = len(seq) - a.k + 1
        km = np.zeros(n, dtype=np.uint64)
        bad = np.zeros(n, dtype=bool)
        for t in range(a.k):
            km |= codes[t : t + n] << np.uint64(2 * (a.k - 1 - t))
            bad |= ambig[t : t + n]
        block = HLL(a.precision, sparse=False)
        block.insert_items(km[~bad])
        counter.merge(block)
    print(counter.cardinality())
    return 0


def read_uid_mapping_main(argv=None) -> int:
    """Dump / query a UID map file (read_uid_mapping.cpp:29-67)."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-read-uid-mapping")
    p.add_argument("uid_map")
    p.add_argument("uids", nargs="*", type=int)
    a = p.parse_args(argv)
    from ..classify.uid import UidMap

    m = UidMap(a.uid_map)
    if not a.uids:
        for i in range(len(m)):
            print(f"{i + 1}\t{m.taxids[i]}\t{m.parents[i]}")
    else:
        for uid in a.uids:
            taxids = " ".join(str(t) for t in m.taxid_set(uid).tolist())
            print(f"{uid}\t{taxids} ")
    return 0


def upgrade_db_main(argv=None) -> int:
    """Upgrade a pre-v0.10 database (v1 KRAKIDX plain minimizer order) to the
    v2 XOR-scrambled order (scripts/upgrade_db.sh semantics: minimizer length
    recovered from the index size, DB re-binned and re-sorted)."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-upgrade-db")
    p.add_argument("db_dir")
    a = p.parse_args(argv)
    import os

    import numpy as np

    from ..formats import read_kdb, read_index, write_kdb, write_index
    from ..utils.bits import bin_key

    idx_path = os.path.join(a.db_dir, "database.idx")
    kdb_path = os.path.join(a.db_dir, "database.kdb")
    idx_type, nt, _ = read_index(idx_path)
    if idx_type == 2:
        print("Database index is already v2 (scrambled minimizer order).", file=sys.stderr)
        return 0
    hdr, keys, vals = read_kdb(kdb_path)
    print(f"Re-sorting {hdr.key_ct} k-mers to scrambled minimizer order (nt={nt})",
          file=sys.stderr)
    b = bin_key(keys, hdr.k, nt)
    order = np.lexsort((keys, b))
    keys, vals, b = keys[order], vals[order], b[order]
    counts = np.bincount(b.astype(np.int64), minlength=4**nt)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
    os.replace(kdb_path, kdb_path + ".v1")
    os.replace(idx_path, idx_path + ".v1")
    write_kdb(kdb_path, keys, vals, k=hdr.k)
    write_index(idx_path, nt, offsets, idx_type=2)
    print("Upgrade complete (originals kept as .v1).", file=sys.stderr)
    return 0


def grade_main(argv=None) -> int:
    """Grade classifications of simulated reads (grade_classification.cpp):
    usage: grade <taxDB> <seqid2taxid.map> <kraken output> <per-read out>."""
    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-grade")
    p.add_argument("taxdb")
    p.add_argument("seqid_map")
    p.add_argument("kraken")
    p.add_argument("per_read_out")
    a = p.parse_args(argv)
    from ..report.grade import grade

    with open(a.per_read_out, "w") as fh:
        grade(a.taxdb, a.seqid_map, a.kraken, fh)
    return 0


def get_kmers_main(argv=None) -> int:
    """k-mer -> taxa-set dump over a library (get_kmers.cpp equivalent).

    The reference tool (get_kmers.cpp:212-224, an orphan never wired into a
    Makefile target) collects a kmer->taxid multimap from library sequences
    and bit-rotted before growing an output stage; this completes it: one
    line per distinct canonical k-mer, `<kmer-int>\\t<taxid,taxid,...>`
    (taxids ascending), k taken from the database header. Sequence taxids
    resolve like set_lcas (seqid2taxid map, version-suffix fallback,
    kraken:taxid| headers)."""
    import argparse

    p = argparse.ArgumentParser(prog="krakenuniq-tpu-torch-get-kmers")
    p.add_argument("-d", "--db", required=True, help="database.kdb (for k)")
    p.add_argument("-m", "--seqid-map", required=True, help="seqid2taxid.map")
    p.add_argument("-F", "--fasta", required=True, action="append", help="library FASTA")
    p.add_argument("-o", "--output", default="-")
    a = p.parse_args(argv)

    import sys

    import numpy as np

    from ..build.db_build import extract_canonical_kmers, resolve_seq_taxid
    from ..formats import read_kdb
    from ..formats.seqio import read_sequences
    from ..formats.seqmap import read_seqid2taxid

    hdr, _, _ = read_kdb(a.db)
    seqmap = read_seqid2taxid(a.seqid_map)
    pairs = []
    for path in a.fasta:
        for dna in read_sequences(path):
            taxid = resolve_seq_taxid(dna.id, seqmap)
            if not taxid or not dna.seq:
                continue
            km = extract_canonical_kmers(dna.seq, hdr.k)
            if len(km):
                pairs.append(
                    np.stack([km, np.full(len(km), taxid, dtype=np.uint64)], axis=1)
                )
    out = sys.stdout if a.output == "-" else open(a.output, "w")
    try:
        if pairs:
            allp = np.unique(np.concatenate(pairs), axis=0)
            kmers = allp[:, 0]
            starts = np.concatenate(
                [[0], np.flatnonzero(kmers[1:] != kmers[:-1]) + 1, [len(kmers)]]
            )
            for s, e in zip(starts[:-1], starts[1:]):
                taxa = ",".join(str(int(t)) for t in allp[s:e, 1])
                out.write(f"{int(kmers[s])}\t{taxa}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0
