"""seqid -> taxid map file (`seqid2taxid.map`): text lines `seqid\ttaxid`."""

from __future__ import annotations

import os


def read_seqid2taxid(path: str | os.PathLike) -> dict[str, int]:
    out: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            out[fields[0]] = int(fields[1])
    return out


def write_seqid2taxid(path: str | os.PathLike, mapping: dict[str, int]) -> None:
    with open(path, "w") as f:
        for seqid, taxid in mapping.items():
            f.write(f"{seqid}\t{taxid}\n")
