"""Classification grading against simulated-read ground truth
(reference src/grade_classification.cpp).

Reads carry their source sequence id after the 5th underscore (the BBMap
randomreads.sh convention, grade_classification.cpp:101-108); grading maps
that to the true taxid and scores the kraken calls per rank:
  * read-level: correct/incorrect calls at or below each rank of interest
    (assembly, species, genus, family, order), sensitivity/precision
  * taxon-level: identified vs simulated taxon sets, recall/precision

Deviation from the reference (documented): the reference's per-read LCA
"distance" column mixes in std::unordered_set iteration positions
(taxdb.hpp:654), which is implementation-defined; we print the real tree
distance.
"""

from __future__ import annotations

import sys

from ..formats.seqmap import read_seqid2taxid
from ..taxonomy import Taxonomy
from .taxreport import cpp_float

RANK_ORDER = [
    "unknown", "no rank", "sequence", "assembly", "subspecies", "species",
    "species subgroup", "species group", "subgenus", "genus", "tribe",
    "subfamily", "family", "superfamily", "parvorder", "infraorder",
    "suborder", "order", "superorder", "parvclass", "infraclass", "subclass",
    "class", "superclass", "subphylum", "phylum", "kingdom", "superkingdom",
    "root",
]
RANK_INDEX = {r: i for i, r in enumerate(RANK_ORDER)}
RANKS_OF_INTEREST = ["assembly", "species", "genus", "family", "order"]


def _next_proper_rank(tax: Taxonomy, taxid: int) -> str:
    """taxdb.hpp:607-619 semantics."""
    if taxid == 0:
        return "NA"
    t = taxid
    while tax.rank_of(t) == "no rank":
        p = tax.parent_map().get(t, 0)
        if p == 0 or p == t:
            break
        t = p
    if t == 1:
        return "root"
    return tax.rank_of(t)


def _fixed2(v: float) -> str:
    return f"{v:.2f}"


def grade(
    taxdb_path: str,
    seqid_map_path: str,
    kraken_path: str,
    per_read_out,
    stats_out=None,
) -> dict:
    """Grade a kraken output of simulated reads (grade_classification.cpp):
    a line a read to `per_read_out`, the rank tables to `stats_out` (the
    sys.stdout of the call's moment by default)."""
    stats_out = sys.stdout if stats_out is None else stats_out
    tax = Taxonomy.from_taxdb_file(taxdb_path)
    pm = tax.parent_map()
    seqid_map = read_seqid2taxid(seqid_map_path)
    known = set(int(t) for t in tax.taxids)

    def depth_chain(t: int) -> list[int]:
        chain = [t]
        while True:
            p = pm.get(chain[-1], 0)
            if p == 0 or p == chain[-1]:
                break
            chain.append(p)
        return chain

    sim_at_rank: dict[str, set] = {r: set() for r in RANKS_OF_INTEREST}
    ident_at_rank: dict[str, set] = {r: set() for r in RANKS_OF_INTEREST}
    correct = {r: 0 for r in RANKS_OF_INTEREST}
    incorrect = {r: 0 for r in RANKS_OF_INTEREST}
    higher = {r: 0 for r in RANKS_OF_INTEREST}
    total_reads = 0
    unidentified = 0
    ignored: set[int] = set()

    with open(kraken_path) as f:
        for line in f:
            if not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            read_id, ident = fields[1], int(fields[2])
            classi = fields[4] if len(fields) > 4 else ""
            total_reads += 1
            if ident == 0:
                unidentified += 1
            # The reference's comment says "after the 5th underscore" but its
            # do/while (grade_classification.cpp:101-108) executes SIX finds
            # -- the loop body runs once more after count reaches 5, and
            # `pos != npos` can never be false because npos+1 wraps to 0.
            # Emulate exactly, including the wrap-to-front on short names.
            pos = 0
            for _ in range(6):
                f = read_id.find("_", pos)
                pos = 0 if f == -1 else f + 1
            seq_id = read_id[pos:]
            if seq_id not in seqid_map:
                print(f"ERROR: Couldn't find taxid for {seq_id}", file=sys.stderr)
                continue
            seq_taxid = seqid_map[seq_id]
            if seq_taxid not in known:
                if seq_taxid not in ignored:
                    print(f"Ignoring taxon {seq_taxid} - not in database", file=sys.stderr)
                    ignored.add(seq_taxid)
                continue

            # LCA + real tree distance
            chain_a = depth_chain(seq_taxid)
            chain_b = depth_chain(ident) if ident in known else [ident]
            set_a = {t: i for i, t in enumerate(chain_a)}
            lca, dist = 1, len(chain_a) + len(chain_b)
            for j, t in enumerate(chain_b):
                if t in set_a:
                    lca, dist = t, set_a[t] + j
                    break
            if ident == 0:
                lca, dist = seq_taxid, -1
            lca_rank = _next_proper_rank(tax, lca)

            ident_rank_i = RANK_INDEX.get(tax.rank_of(ident) or "unknown", 0)
            for rank in RANKS_OF_INTEREST:
                sim_tid = tax.taxid_at_rank(seq_taxid, rank)
                ident_tid = tax.taxid_at_rank(ident, rank)
                sim_at_rank[rank].add(sim_tid)
                if ident_rank_i <= RANK_INDEX[rank]:
                    ident_at_rank[rank].add(ident_tid)
                    if sim_tid == ident_tid:
                        correct[rank] += 1
                    else:
                        incorrect[rank] += 1
                else:
                    higher[rank] += 1

            if ident == 0:
                lca_rank = "unidentified"
            next_proper = tax.taxid_at_rank(ident, _next_proper_rank(tax, ident)) if ident else 0
            per_read_out.write(
                f"{read_id}\t{tax.name_of(seq_taxid)}\t{seq_taxid}\t{ident}\t"
                f"{_next_proper_rank(tax, ident) if ident else 'NA'}\t"
                f"{lca_rank}\t{lca}\t{dist}\t{classi}\n"
            )

    d = "\t"
    stats_out.write(
        f"#rank{d}total_reads{d}correct{d}incorrect{d}sensitivity{d}precision"
        f"{d}higher_rank{d}unidentified\n"
    )
    first = True
    for rank in RANKS_OF_INTEREST:
        tp, fp = correct[rank], incorrect[rank]
        sens = 100.0 * tp / total_reads if total_reads else 0.0
        prec = 100.0 * tp / (tp + fp) if tp + fp else float("nan")
        fmt = (lambda v: cpp_float(v, 6)) if first else _fixed2
        stats_out.write(
            f"{rank}{d}{total_reads}{d}{tp}{d}{fp}{d}{fmt(sens)}%{d}{fmt(prec)}%"
            f"{d}{higher[rank]}{d}{unidentified}\n"
        )
        first = False
    stats_out.write(f"#rank{d}true_count{d}correct{d}incorrect{d}recall{d}precision\n")
    for rank in RANKS_OF_INTEREST:
        tp = sum(1 for t in ident_at_rank[rank] if t in sim_at_rank[rank])
        fp = len(ident_at_rank[rank]) - tp
        sens = 100.0 * tp / len(sim_at_rank[rank]) if sim_at_rank[rank] else 0.0
        prec = 100.0 * tp / (tp + fp) if tp + fp else float("nan")
        stats_out.write(
            f"{rank}{d}{len(sim_at_rank[rank])}{d}{tp}{d}{fp}{d}"
            f"{_fixed2(sens)}%{d}{_fixed2(prec)}%\n"
        )
    return {
        "total_reads": total_reads,
        "unidentified": unidentified,
        "correct": correct,
        "incorrect": incorrect,
    }
