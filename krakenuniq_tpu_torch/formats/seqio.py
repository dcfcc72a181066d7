"""FASTA/FASTQ sequence input with transparent decompression.

Mirrors the reference input behavior:
  * format auto-detect by first byte ('@' => FASTQ, else FASTA)
    (classify.cpp:377-388)
  * compression auto-detect by magic bytes (gz/bz2/xz; the reference's
    vendored bxzstr additionally handles zstd -- gated here on the optional
    `zstandard` module)
  * record ids are the first whitespace-delimited token of the header
    (seqreader.cpp:56-58)
  * paired-end merge: mates joined with a single 'N', /1 /2 (or .1 _1 style)
    suffixes stripped from ids (scripts/read_merger.pl:187-191)
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import io
import lzma
import os
import re
from typing import Iterator


@dataclasses.dataclass
class DNASequence:
    id: str
    header_line: str
    seq: str
    quals: str = ""


_GZ_MAGIC = b"\x1f\x8b"
_BZ2_MAGIC = b"BZh"
_XZ_MAGIC = b"\xfd7zXZ\x00"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def open_maybe_compressed(path: str | os.PathLike, mode: str = "rt"):
    """Open a file, transparently decompressing gz/bz2/xz/zstd by magic."""
    with open(path, "rb") as probe:
        head = probe.read(6)
    if head.startswith(_GZ_MAGIC):
        return gzip.open(path, mode)
    if head.startswith(_BZ2_MAGIC):
        return bz2.open(path, mode)
    if head.startswith(_XZ_MAGIC):
        return lzma.open(path, mode)
    if head.startswith(_ZSTD_MAGIC):
        try:
            import zstandard
        except ImportError as e:
            raise RuntimeError(
                f"{path} is zstd-compressed but the zstandard module is unavailable"
            ) from e
        fh = zstandard.open(open(path, "rb"), "rb")
        return io.TextIOWrapper(fh) if "t" in mode else fh
    return open(path, mode)


def open_output(path: str | os.PathLike, mode: str = "wt", append: bool = False):
    """Output writer; paths ending in .gz are gzip-compressed (classify.cpp:133-148)."""
    m = mode.replace("w", "a") if append else mode
    if str(path).endswith(".gz"):
        return gzip.open(path, m)
    return open(path, m)


def is_fastq(path: str | os.PathLike) -> bool:
    """'@' first byte => FASTQ (classify.cpp:377-388)."""
    with open_maybe_compressed(path, "rt") as f:
        first = f.read(1)
    return first == "@"


def read_fasta(fh) -> Iterator[DNASequence]:
    header: str | None = None
    chunks: list[str] = []
    for line in fh:
        line = line.rstrip("\n").rstrip("\r")
        if line.startswith(">"):
            if header is not None:
                yield _fasta_record(header, chunks)
            header = line[1:]
            chunks = []
        else:
            if header is None:
                raise ValueError("malformed fasta file - expected header char >")
            chunks.append(line)
    if header is not None:
        yield _fasta_record(header, chunks)


def _fasta_record(header: str, chunks: list[str]) -> DNASequence:
    rid = header.split(None, 1)[0] if header.split() else ""
    return DNASequence(id=rid, header_line=header, seq="".join(chunks))


def read_fastq(fh) -> Iterator[DNASequence]:
    while True:
        header = fh.readline()
        if not header or not header.strip():
            return
        header = header.rstrip("\n").rstrip("\r")
        if not header.startswith("@"):
            raise ValueError(f"malformed fastq file - sequence header ({header})")
        seq = fh.readline().rstrip("\n").rstrip("\r")
        plus = fh.readline()
        if not plus.startswith("+"):
            raise ValueError("malformed fastq file - quality header")
        quals = fh.readline().rstrip("\n").rstrip("\r")
        header_line = header[1:]
        rid = header_line.split(None, 1)[0] if header_line.split() else ""
        yield DNASequence(id=rid, header_line=header_line, seq=seq, quals=quals)


def read_sequences(path: str | os.PathLike) -> Iterator[DNASequence]:
    fastq = is_fastq(path)
    with open_maybe_compressed(path, "rt") as fh:
        if fastq:
            yield from read_fastq(fh)
        else:
            yield from read_fasta(fh)


_PAIR_SUFFIX_RE = re.compile(r"[/_.][12]$")


def merge_paired(
    path1: str | os.PathLike,
    path2: str | os.PathLike,
    out_fh,
    check_names: bool = False,
) -> int:
    """Concatenate mate pairs with a single 'N' into FASTA records."""
    it1 = read_sequences(path1)
    it2 = read_sequences(path2)
    n = 0
    while True:
        s1 = next(it1, None)
        s2 = next(it2, None)
        if s1 is None and s2 is None:
            break
        for s in (s1, s2):
            if s is not None:
                s.id = _PAIR_SUFFIX_RE.sub("", s.id)
        if s1 is not None and s2 is not None:
            if check_names and s1.id != s2.id:
                raise ValueError(f"paired read names do not match: {s1.id} vs {s2.id}")
            out_fh.write(f">{s1.id}\n{s1.seq}N{s2.seq}\n")
        else:
            s = s1 if s1 is not None else s2
            out_fh.write(f">{s.id}\n{s.seq}\n")
        n += 1
    return n


def format_sequence(dna: DNASequence, fastq: bool) -> str:
    """Echo a record for --classified-out/--unclassified-out (classify.cpp:794-805)."""
    if fastq:
        return f"@{dna.header_line}\n{dna.seq}\n+\n{dna.quals}\n"
    return f">{dna.header_line}\n{dna.seq}\n"
