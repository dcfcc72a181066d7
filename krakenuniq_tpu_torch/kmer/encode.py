"""Host-side 2-bit encoding of read batches into fixed-shape numpy arrays.

Mirrors the KmerScanner base mapping (krakenutil.cpp:253-273): A/a=0, C/c=1,
G/g=2, T/t=3; every other byte is an ambiguous base (code 0, ambig flag set).
CR/LF never reach this point -- the readers strip line endings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 256-entry tables: base code (0..3) and ambiguity flag.
BASE_CODE_TABLE = np.zeros(256, dtype=np.uint8)
AMBIG_TABLE = np.ones(256, dtype=bool)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    for _c in (_ch, _ch.lower()):
        BASE_CODE_TABLE[ord(_c)] = _code
        AMBIG_TABLE[ord(_c)] = False


@dataclasses.dataclass
class EncodedBatch:
    """Fixed-shape encoded reads: codes/ambig padded to width `lb`."""

    codes: np.ndarray  # uint8 [B, LB]
    ambig: np.ndarray  # bool  [B, LB]
    lengths: np.ndarray  # int32 [B]

    @property
    def batch(self) -> int:
        return self.codes.shape[0]

    @property
    def lb(self) -> int:
        return self.codes.shape[1]


def encode_batch(seqs: list[str] | list[bytes], lb: int, batch: int | None = None) -> EncodedBatch:
    """Encode sequences into a (B, LB) code/ambig array pair.

    Sequences longer than lb must be pre-segmented by the caller. Padding
    positions are marked ambiguous so windows crossing the pad never match.
    """
    b = batch if batch is not None else len(seqs)
    codes = np.zeros((b, lb), dtype=np.uint8)
    ambig = np.ones((b, lb), dtype=bool)
    lengths = np.zeros(b, dtype=np.int32)
    for i, s in enumerate(seqs):
        raw = s.encode("ascii", "replace") if isinstance(s, str) else s
        if len(raw) > lb:
            raise ValueError(f"sequence of length {len(raw)} exceeds batch width {lb}")
        arr = np.frombuffer(raw, dtype=np.uint8)
        codes[i, : len(arr)] = BASE_CODE_TABLE[arr]
        ambig[i, : len(arr)] = AMBIG_TABLE[arr]
        lengths[i] = len(arr)
    return EncodedBatch(codes=codes, ambig=ambig, lengths=lengths)
