"""Clade-aggregated classification report, byte-compatible with the
reference TaxReport (taxdb.hpp:928-1123).

Structure: every taxon's ReadCounts contributes to itself and every ancestor
(taxdb.hpp:935-951); clade counts are the merged contributions; the printed
tree is a DFS from the synthetic unclassified node (0) then the root (1),
with siblings in decreasing (readCount, kmerCount) order (taxdb.hpp:1047-1076,
readcounts.hpp:90-98).

Formatting notes (taxdb.hpp:1079-1123):
  * '%' and 'cov' use C++ `setprecision(4)` default-float formatting
    (== printf %.4g), 'dup' uses precision 3
  * 0/0 in 'dup' prints "-nan" (x86 glibc behavior for the produced QNaN);
    x/0 prints "inf"; a zero genome size prints cov as "NA"
  * taxID is printed through an int32 cast
"""

from __future__ import annotations

import math

import numpy as np

from ..hll import ExactCounter, ReadCounts
from ..taxonomy import Taxonomy

DEFAULT_COLS = ["%", "reads", "taxReads", "kmers", "dup", "cov", "taxID", "rank", "taxName"]
FULL_COLS = [
    "%",
    "reads",
    "taxReads",
    "kmers",
    "taxKmers",
    "kmersDB",
    "taxKmersDB",
    "dup",
    "cov",
    "taxID",
    "rank",
    "taxName",
]
NO_HLL_COLS = ["%", "reads", "taxReads", "taxID", "rank", "taxName"]


def cpp_float(v: float, precision: int) -> str:
    """C++ `os << setprecision(p) << v` for the default float format."""
    if math.isnan(v):
        return "-nan"  # x86 0.0/0.0 QNaN as printed by glibc
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.{precision}g}"


def _clade_counts(rcs: list[ReadCounts]) -> ReadCounts:
    """A clade's counts: the sum of its contributions and the union of their
    k-mer containers. Exact containers (--exact) are united in one pass: one
    by one, each merge re-sorts the clade's growing set, which at the root
    of a 400-species run is hundreds of sorts of up to ~10M k-mers."""
    if len(rcs) > 1 and all(isinstance(r.kmers, ExactCounter) for r in rcs):
        agg = ReadCounts(ExactCounter())
        agg.n_reads = sum(r.n_reads for r in rcs)
        agg.n_kmers = sum(r.n_kmers for r in rcs)
        agg.kmers.kmers = np.unique(np.concatenate([r.kmers.kmers for r in rcs]))
        return agg
    agg = rcs[0].copy()
    for r in rcs[1:]:
        agg.iadd(r)
    return agg


class TaxReport:
    def __init__(
        self,
        taxonomy: Taxonomy,
        taxon_counts: dict[int, ReadCounts],
        show_zeros: bool = False,
    ):
        self.tax = taxonomy
        self.taxon_counts = taxon_counts
        self.show_zeros = show_zeros
        self.cols = list(DEFAULT_COLS)
        self._clade: dict[int, ReadCounts] = {}
        self._aggregate()

    def _aggregate(self) -> None:
        """Fan each taxon's counts out to itself + all ancestors, then merge
        per clade (taxdb.hpp:935-973)."""
        contributions: dict[int, list[ReadCounts]] = {}
        tax = self.tax
        for taxid in sorted(self.taxon_counts):
            rc = self.taxon_counts[taxid]
            i = int(tax.dense_index(np.asarray([taxid], dtype=np.uint32))[0])
            if int(tax.taxids[i]) != int(taxid):
                import sys

                print(f"No entry for {taxid} in database!", file=sys.stderr)
                continue
            while True:
                contributions.setdefault(int(tax.taxids[i]), []).append(rc)
                p = int(tax.parent[i])
                if p == i:
                    break
                i = p
        for taxid, rcs in contributions.items():
            self._clade[taxid] = _clade_counts(rcs)

    def set_cols(self, cols: list[str]) -> None:
        self.cols = list(cols)

    def total_reads(self) -> int:
        """Reads under unclassified (0) + root (1) (taxdb.hpp:1003-1012)."""
        total = 0
        for t in (0, 1):
            rc = self._clade.get(t)
            if rc is not None:
                total += rc.n_reads
        return total

    def write(self, fh) -> None:
        total = self.total_reads()
        if total == 0:
            import sys

            print("total number of reads is zero - not creating a report!", file=sys.stderr)
            return
        fh.write("\t".join(self.cols) + "\n")
        for t in (0, 1):
            i = int(self.tax.dense_index(np.asarray([t], dtype=np.uint32))[0])
            if int(self.tax.taxids[i]) == t:
                self._print_subtree(i, 0, total, fh)

    def _print_subtree(self, dense: int, depth: int, total: int, fh) -> None:
        taxid = int(self.tax.taxids[dense])
        clade = self._clade.get(taxid)
        if clade is None:
            return
        if not self.show_zeros and clade.n_reads == 0:
            return
        self._print_line(dense, clade, depth, total, fh)
        # children with clade counts, sorted descending by (reads, kmers);
        # stable w.r.t. child order for ties
        kids = []
        for c in self.tax.children[dense]:
            crc = self._clade.get(int(self.tax.taxids[int(c)]))
            if crc is not None:
                kids.append((int(c), crc))
        kids.sort(key=lambda kc: kc[1].sort_key(), reverse=True)
        for c, _ in kids:
            self._print_subtree(c, depth + 1, total, fh)

    def _print_line(self, dense: int, rc: ReadCounts, depth: int, total: int, fh) -> None:
        tax = self.tax
        taxid = int(tax.taxids[dense])
        self_rc = self.taxon_counts.get(taxid)
        unique_clade = rc.unique_kmer_count()
        genome_size = float(int(tax.genome_size[dense]) + int(tax.genome_size_children[dense]))
        out = []
        for col in self.cols:
            if col == "%":
                out.append(cpp_float(100.0 * rc.n_reads / total, 4))
            elif col in ("reads", "cladeReads", "reads_clade", "cladePerc-reads"):
                out.append(str(rc.n_reads))
            elif col in ("taxReads", "reads_stay", "numReadsTaxon"):
                out.append(str(self_rc.n_reads if self_rc else 0))
            elif col in ("kmers", "numUniqueKmersClade", "specificCladeKmers"):
                out.append(str(unique_clade))
            elif col in ("taxKmers", "numKmersTaxon", "specificTaxKmers", "numUniqueKmersTaxon"):
                # NUM_KMERS / NUM_UNIQUE_KMERS both print the taxon's kmerCount
                # (taxdb.hpp:1098-1100)
                out.append(str(self_rc.n_kmers if self_rc else 0))
            elif col in ("cladeKmers", "numKmersClade"):
                out.append(str(rc.n_kmers))
            elif col in ("kmersDB", "cladeKmersInDB", "numKmersInDatabaseClade"):
                out.append(str(int(tax.genome_size[dense]) + int(tax.genome_size_children[dense])))
            elif col in ("taxKmersDB", "taxKmersInDB", "numKmersInDatabaseTaxon"):
                out.append(str(int(tax.genome_size[dense])))
            elif col in ("dup", "kmerDup"):
                if unique_clade == 0:
                    v = float("nan") if rc.n_kmers == 0 else float("inf")
                else:
                    v = float(rc.n_kmers) / unique_clade
                out.append(cpp_float(v, 3))
            elif col in ("cov", "kmerCov"):
                if genome_size == 0:
                    out.append("NA")
                else:
                    out.append(cpp_float(unique_clade / genome_size, 4))
            elif col in ("taxID", "taxId"):
                out.append(str(np.int32(np.uint32(taxid))))
            elif col in ("rank", "taxRank"):
                out.append(tax.ranks[dense])
            elif col in ("taxName", "indentedName"):
                out.append("  " * depth + tax.names[dense])
            elif col == "name":
                out.append(tax.names[dense])
            elif col == "depth":
                out.append(str(depth))
            else:
                raise ValueError(f"{col} is not a valid report column name")
        fh.write("\t".join(out) + "\n")
