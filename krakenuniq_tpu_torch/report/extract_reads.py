"""Extract reads by taxon from kraken output + FASTA/FASTQ
(scripts/krakenuniq-extract-reads semantics, including quirks:
  * the taxid filter matches the CALL column exactly; -t includes the
    subtree via taxDB child lists
  * exits early printing nothing when no read matched, even in inverted
    mode (:128 `exit(0) if sum_reads==0` runs before inversion)
  * read ids are truncated at whitespace and a trailing /1 .1 /2 .2 is
    always stripped
  * FASTA input requires -a (which implies FASTA output); FASTQ is the
    default and echoes all four lines)
"""

from __future__ import annotations

import os
import re
import sys

from ..formats.seqio import open_maybe_compressed

_PAIR_RE = re.compile(r"[/.][12]$")


def _collect_children(children: dict[int, list[int]], roots) -> set[int]:
    out: set[int] = set()
    stack = list(roots)
    while stack:
        node = stack.pop()
        for c in children.get(node, []):
            if c not in out:
                out.add(c)
                stack.append(c)
    return out


def extract_reads(
    taxids: list[int],
    kraken_path: str,
    seq_path: str,
    out_fh,
    fasta_input: bool = False,  # -a
    fasta_output: bool = False,  # -f
    invert: bool = False,  # -i
    taxdb_path: str | None = None,  # -t
    paired: bool = False,  # -p, '%' in seq_path
) -> int:
    wanted = {int(t) for t in taxids}
    if taxdb_path:
        children: dict[int, list[int]] = {}
        with open(taxdb_path) as f:
            for line in f:
                fields = line.split("\t")
                t, p = int(fields[0]), int(fields[1])
                if t != p:
                    children.setdefault(p, []).append(t)
        wanted |= _collect_children(children, wanted)

    marked: dict[str, int] = {}
    per_taxon = {t: 0 for t in wanted}
    with open_maybe_compressed(kraken_path, "rt") as f:
        for line in f:
            fields = line.split("\t")
            if len(fields) < 3:
                continue
            readid, taxid = fields[1], int(fields[2])
            if taxid in wanted:
                marked[readid] = taxid
                per_taxon[taxid] += 1
            elif -1 in wanted:
                marked[readid] = -1
                per_taxon[-1] += 1
    for t in sorted(per_taxon):
        print("  Found %5s reads for %s" % (per_taxon[t], t), file=sys.stderr)
    if sum(per_taxon.values()) == 0:
        return 0  # bug-compatible early exit (applies to inverted mode too)

    if fasta_input:
        fasta_output = True

    def norm(raw_id: str) -> str:
        rid = raw_id.split()[0]
        return _PAIR_RE.sub("", rid)

    count = 0

    def mates(path):
        if paired:
            return (path.replace("%", "1"), path.replace("%", "2"))
        return (path, None)

    p1, p2 = mates(seq_path)
    fh1 = open_maybe_compressed(p1, "rt")
    fh2 = open_maybe_compressed(p2, "rt") if p2 else None

    if fasta_input:
        # multi-line FASTA input
        cur_id = None
        printing = False
        for line in fh1:
            if line.startswith(">"):
                cur_id = norm(line[1:])
                printing = (cur_id in marked) != invert
                if printing:
                    count += 1
                    out_fh.write(f">{cur_id}\n")
            elif printing:
                out_fh.write(line)
    else:
        while True:
            header = fh1.readline()
            if not header:
                break
            seq = fh1.readline()
            plus = fh1.readline()
            quals = fh1.readline()
            rid = norm(header[1:])
            h2 = s2 = q2 = None
            if fh2:
                h2, s2 = fh2.readline(), fh2.readline()
                fh2.readline()
                q2 = fh2.readline()
            if (rid in marked) != invert:
                count += 1
                if fasta_output:
                    out_fh.write(f">{rid}\n{seq}")
                    if fh2:
                        out_fh.write(f">{rid}\n{s2}")
                else:
                    out_fh.write(header + seq + plus + quals)
                    if fh2:
                        out_fh.write(h2 + s2 + "+\n" + q2)
    fh1.close()
    if fh2:
        fh2.close()
    print("Number of extracted reads: %10s" % count, file=sys.stderr)
    return count
