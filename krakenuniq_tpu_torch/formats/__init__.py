"""Readers/writers for the reference on-disk formats (host numpy)."""

from .kdb import KdbHeader, read_kdb, write_kdb, KRAKEN_DB_MAGIC
from .index import read_index, write_index, KRAKEN_IDX_MAGIC_V1, KRAKEN_IDX_MAGIC_V2
from .counts import read_counts, write_counts

__all__ = [
    "KdbHeader",
    "read_kdb",
    "write_kdb",
    "read_index",
    "write_index",
    "read_counts",
    "write_counts",
    "KRAKEN_DB_MAGIC",
    "KRAKEN_IDX_MAGIC_V1",
    "KRAKEN_IDX_MAGIC_V2",
]
