"""`krakenuniq-tpu-torch-download` -- NCBI library/taxonomy downloader CLI,
pattern- and flag-compatible with scripts/krakenuniq-download."""

from __future__ import annotations

import argparse
import sys

from .. import __version__


def build_parser():
    p = argparse.ArgumentParser(
        prog="krakenuniq-tpu-torch-download",
        description=(
            "Download reference sequences and taxonomy from NCBI. Patterns: "
            "'taxonomy', 'contaminants', 'viral-neighbors', "
            "'refseq/DOMAINS[/ASS_LEVELS[/COL=VAL]*]', 'genbank/DOMAINS[...]' "
            "(comma lists fan out), 'nucleotide'/'assembly'/'genome' (with "
            "--search/--ac), and 'nt'/'microbial-nt' (taxa-filtered nt "
            "subsets, see --taxa)"
        ),
    )
    p.add_argument("patterns", nargs="+")
    p.add_argument("-o", "--output", default=".", help="download directory")
    p.add_argument("--db", default=None, help="download to <db>/{library,taxonomy}")
    p.add_argument(
        "--threads", "-P", type=int, default=5,
        help="parallel assembly fetches (the reference forks a pool of 5, "
        "krakenuniq-download:57,389-417)",
    )
    p.add_argument("--rsync", "-R", action="store_true", help="accepted no-op (https used)")
    p.add_argument(
        "--overwrite", "--force", action="store_true",
        help="re-download existing files (the reference spells this --force)",
    )
    p.add_argument("--verbose", action="store_true")
    p.add_argument(
        "-d", "--domain", default=None,
        help="default DOMAINS for refseq/genbank patterns that omit them "
        "(krakenuniq-download:271); a pattern with neither fetches nothing",
    )
    p.add_argument(
        "-a", "--assembly-level", default="Complete_Genome",
        help="default ASSEMBLY_LEVELS for refseq/genbank patterns that omit "
        "them (krakenuniq-download:272; default Complete_Genome, as in the "
        "reference, krakenuniq-download:51; 'Any' takes every level)",
    )
    p.add_argument(
        "-c", "--category", default=None,
        help="keep only assemblies whose refseq_category column matches "
        "exactly (krakenuniq-download:1204), e.g. 'reference genome'",
    )
    # parsed-but-unused in the reference (declared at krakenuniq-download:
    # 213,223,226,229 and never read again); accepted for drop-in parity
    p.add_argument("-t", "--taxonomy-id", default=None,
                   help="accepted no-op (dead flag in the reference)")
    p.add_argument("--nt-fna", default=None,
                   help="accepted no-op (dead flag in the reference)")
    p.add_argument("-l", "--change-header", action="store_true",
                   help="accepted no-op (dead flag in the reference)")
    p.add_argument("--ncbidb", default=None,
                   help="accepted no-op (dead flag in the reference)")
    p.add_argument("--dust", "-D", action="store_true", help="dustmask low-complexity regions")
    p.add_argument("--min-seq-len", type=int, default=0)
    p.add_argument("--fna", default="genomic", help="sequence types for refseq/genbank")
    p.add_argument("--search", "--term", dest="search", default=None)
    p.add_argument("--ac", default=None, help="comma-separated accessions")
    p.add_argument("--rettype", default="fasta")
    p.add_argument("--retmode", default="text")
    p.add_argument("--mapping-file", default=None, help="accepted no-op (taxids from summaries)")
    p.add_argument(
        "--taxa",
        default=None,
        help="comma list of taxa kept in nt/microbial-nt subsets: division "
        "names (bacteria, archaea, viral, fungi, protozoa, parasitic_worms) "
        "or taxIDNNN entries; default bacteria,archaea,viral,fungi,protozoa",
    )
    p.add_argument(
        "--exclude-environmental-taxa",
        action="store_true",
        help="prune 'environmental samples' subtrees from nt taxa filters",
    )
    p.add_argument(
        "--filter-unplaced",
        "-u",
        action="store_true",
        help="accepted for compatibility; unimplemented in the reference "
        "too (krakenuniq-download:1278) -- a warning is printed",
    )
    p.add_argument("--version", action="version", version=f"KrakenUniq-TPU-torch version {__version__}")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..build.download import Downloader

    db_dir = args.db or args.output
    dl = Downloader(
        db_dir,
        overwrite=args.overwrite,
        dust=args.dust,
        min_seq_len=args.min_seq_len,
        verbose=True,
        threads=args.threads,
        taxa=args.taxa,
        exclude_environmental_taxa=args.exclude_environmental_taxa,
    )
    if args.filter_unplaced:
        print(
            "warning: --filter-unplaced is accepted for compatibility but "
            "does nothing (the reference never implemented it, "
            "krakenuniq-download:1278)",
            file=sys.stderr,
        )
    for pattern in args.patterns:
        try:
            if pattern in ("nucleotide", "assembly", "genome"):
                if not args.ac and not args.search:
                    print(
                        f"'{pattern}' needs --search or --ac", file=sys.stderr
                    )
                    return 64
                if args.ac:
                    if pattern == "nucleotide":
                        dl.download_accessions(
                            args.ac.split(","), rettype=args.rettype
                        )
                    else:
                        dl.download_eutils_accessions(pattern, args.ac.split(","))
                if args.search:
                    db = "nuccore" if pattern == "nucleotide" else pattern
                    dl.download_search(
                        pattern, args.search, args.retmode, args.rettype, db=db
                    )
            elif pattern == "refseq" or pattern == "genbank" or pattern.startswith(
                ("refseq/", "genbank/")
            ):
                dl.download_assemblies(
                    pattern,
                    fna_types=args.fna,
                    default_domains=args.domain,
                    default_level=args.assembly_level,
                    category=args.category,
                )
            else:
                dl.download(pattern)
        except ValueError as e:
            print(f"krakenuniq-tpu-torch-download: {e}", file=sys.stderr)
            return 64
        except OSError as e:
            print(
                f"krakenuniq-tpu-torch-download: network error for {pattern}: {e}",
                file=sys.stderr,
            )
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
