"""Post-processing tools over kraken output files, equivalent to the
reference's Perl L6 scripts (each function cites its source script).

All operate on a "simple taxonomy" -- the raw taxDB text maps, with child
lists in FILE ORDER (the Perl scripts build child lists while streaming the
file), which matters for sibling ordering ties.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from ..formats.seqio import open_maybe_compressed

RANK_CODES = {
    "species": "S",
    "genus": "G",
    "family": "F",
    "order": "O",
    "class": "C",
    "phylum": "P",
    "kingdom": "K",
    "superkingdom": "D",
}


@dataclasses.dataclass
class SimpleTaxonomy:
    parent: dict[int, int]  # excludes self-parents (roots have no entry)
    name: dict[int, str]
    rank: dict[int, str]
    children: dict[int, list[int]]  # file order

    @classmethod
    def load(cls, db_dir: str | os.PathLike) -> "SimpleTaxonomy":
        parent: dict[int, int] = {}
        name: dict[int, str] = {}
        rank: dict[int, str] = {}
        children: dict[int, list[int]] = {}
        with open(os.path.join(db_dir, "taxDB")) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 4:
                    continue
                t, p = int(fields[0]), int(fields[1])
                name[t] = fields[2]
                rank[t] = fields[3]
                if p != t:
                    parent[t] = p
                    children.setdefault(p, []).append(t)
        return cls(parent=parent, name=name, rank=rank, children=children)

    def rank_code(self, taxid: int) -> str:
        return RANK_CODES.get(self.rank.get(taxid, ""), "-")


def _read_taxid_counts(paths, mode: str):
    """Count calls per taxon over kraken output files
    (krakenuniq-report:99-124)."""
    counts: dict[int, int] = {0: 0}
    total = 0
    for path in paths:
        with open_maybe_compressed(path, "rt") as f:
            for line in f:
                if mode == "taxon-counts":
                    fields = line.split()
                    if not fields:
                        continue
                    t = int(fields[0])
                    c = int(fields[1]) if len(fields) > 1 else 1
                    counts[t] = counts.get(t, 0) + c
                    total += c
                elif mode == "taxon-list":
                    for t in line.split():
                        counts[int(t)] = counts.get(int(t), 0) + 1
                        total += 1
                else:
                    fields = line.split("\t")
                    if len(fields) < 3:
                        continue
                    t = int(fields[2])
                    counts[t] = counts.get(t, 0) + 1
                    total += 1
    return counts, total


def _clade_sum(tax: SimpleTaxonomy, counts: dict[int, int]) -> dict[int, int]:
    clade = dict(counts)

    def dfs(node: int) -> None:
        for child in tax.children.get(node, []):
            dfs(child)
            clade[node] = clade.get(node, 0) + clade.get(child, 0)

    sys.setrecursionlimit(max(sys.getrecursionlimit(), len(tax.name) + 1000))
    dfs(1)
    return clade


def basic_report(
    db_dir: str,
    kraken_paths: list[str],
    out_fh,
    show_zeros: bool = False,
    mode: str = "kraken",
) -> None:
    """Fallback report without k-mer columns (scripts/krakenuniq-report)."""
    tax = SimpleTaxonomy.load(db_dir)
    counts, total = _read_taxid_counts(kraken_paths, mode)
    for t in counts:
        if t not in tax.name:
            print(f"Taxon {t} is not in taxonomy tables - ignoring it.", file=sys.stderr)
    clade = _clade_sum(tax, counts)

    def line(taxid: int, code: str, depth: int, name: str) -> str:
        return "%6.2f\t%d\t%d\t%s\t%d\t%s%s\n" % (
            clade.get(taxid, 0) * 100 / total,
            clade.get(taxid, 0),
            counts.get(taxid, 0),
            code,
            taxid,
            "  " * depth,
            name,
        )

    out_fh.write(line(0, "U", 0, "unclassified"))

    def dfs(node: int, depth: int) -> None:
        if not clade.get(node) and not show_zeros:
            return
        out_fh.write(line(node, tax.rank_code(node), depth, tax.name.get(node, "")))
        kids = tax.children.get(node, [])
        for child in sorted(kids, key=lambda c: clade.get(c, 0), reverse=True):
            dfs(child, depth + 1)

    dfs(1, 0)


def translate(
    db_dir: str, kraken_paths: list[str], out_fh, mpa_format: bool = False
) -> None:
    """Read -> lineage strings (scripts/krakenuniq-translate)."""
    tax = SimpleTaxonomy.load(db_dir)
    cache: dict[int, str] = {}

    def lineage(taxid: int) -> str:
        if taxid in cache:
            return cache[taxid]
        orig = taxid
        nodes: list[str] = []
        while taxid in tax.parent:
            if mpa_format:
                code = tax.rank_code(taxid)
                if code != "-":
                    nodes.insert(0, code.lower() + "__" + tax.name[taxid].replace(" ", "_"))
            else:
                nodes.insert(0, tax.name.get(taxid, ""))
            taxid = tax.parent[taxid]
        if mpa_format:
            s = "|".join(nodes) if nodes else "root"
        else:
            s = ";".join(nodes)
        cache[orig] = s
        return s

    for path in kraken_paths:
        with open_maybe_compressed(path, "rt") as f:
            for line in f:
                if not line.startswith("C"):
                    continue
                fields = line.split()
                out_fh.write(f"{fields[1]}\t{lineage(int(fields[2]))}\n")


def filter_output(
    db_dir: str, kraken_paths: list[str], out_fh, threshold: float
) -> None:
    """Confidence filter: walk the call up until >= threshold of unambiguous
    k-mers sit at/below the node (scripts/krakenuniq-filter:99-134)."""
    tax = SimpleTaxonomy.load(db_dir)
    for path in kraken_paths:
        with open_maybe_compressed(path, "rt") as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                _, seqid, called, length, hit_list = fields[:5]
                hit_counts: dict[str, int] = {}
                for part in hit_list.split():
                    taxid_s, ct = part.split(":")
                    hit_counts[taxid_s] = hit_counts.get(taxid_s, 0) + int(ct)
                hit_sums: dict[int, int] = {}
                total_unambig = 0
                for taxid_s, count in hit_counts.items():
                    if taxid_s == "A":
                        continue
                    total_unambig += count
                    t = int(taxid_s)
                    if t > 0:
                        while t in tax.parent:
                            hit_sums[t] = hit_sums.get(t, 0) + count
                            t = tax.parent[t]
                pct = 0.0
                new_taxon = int(called)
                while new_taxon in tax.parent:
                    pct = hit_sums.get(new_taxon, 0) / total_unambig
                    if pct >= threshold - 1e-5:
                        break
                    new_taxon = tax.parent[new_taxon]
                out_fh.write(
                    "%s\t%s\t%d\t%s\tP=%0.3f\t%s\n"
                    % ("C" if new_taxon > 0 else "U", seqid, new_taxon, length, pct, hit_list)
                )


def mpa_report(
    db_dir: str,
    kraken_paths: list[str],
    out_fh,
    show_zeros: bool = False,
    header_line: bool = False,
    intermediate_ranks: bool = False,
) -> None:
    """MetaPhlAn-style multi-sample report (scripts/krakenuniq-mpa-report)."""
    tax = SimpleTaxonomy.load(db_dir)
    file_data = []
    hit_taxa: dict[int, int] = {}
    for path in kraken_paths:
        counts, _ = _read_taxid_counts([path], "kraken")
        clade = _clade_sum(tax, counts)
        for t, c in clade.items():
            if c:
                hit_taxa[t] = hit_taxa.get(t, 0) + 1
        file_data.append(clade)

    rank_codes = ["D", "K", "P", "C", "O", "F", "G", "S"]
    if intermediate_ranks:
        rank_codes.append("X")
    blocks = {c: [] for c in rank_codes}
    if header_line:
        out_fh.write("#Sample ID\t" + "\t".join(kraken_paths) + "\n")

    def sanitize(taxid: int) -> str:
        n = tax.name.get(taxid, "")
        return n.replace("|", "").replace(".", "").replace(" ", "_")

    def dfs(node: int, name: str | None) -> None:
        if not show_zeros and not hit_taxa.get(node):
            return
        code = tax.rank_code(node)
        if code != "-" or intermediate_ranks:
            if code == "-":
                code = "X"
            name = (name + "|" if name is not None else "") + code.lower() + "__" + sanitize(node)
            row = name + "".join("\t%d" % fd.get(node, 0) for fd in file_data)
            blocks[code].append(row + "\n")
        for child in tax.children.get(node, []):
            dfs(child, name)

    dfs(1, None)
    for code in rank_codes:
        out_fh.writelines(blocks[code])
