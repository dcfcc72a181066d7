"""Database directory resolution (scripts/krakenlib.pm:28-74 semantics):
names without '/' are searched in KRAKEN_DB_PATH (colon-separated), a bare
call uses KRAKEN_DEFAULT_DB."""

from __future__ import annotations

import os


def find_db(name: str | None = None) -> str:
    if name is None:
        name = os.environ.get("KRAKEN_DEFAULT_DB")
        if not name:
            raise ValueError("Must specify database name (no KRAKEN_DEFAULT_DB set)")
    if "/" in name:
        if not os.path.isdir(name):
            raise ValueError(f"unable to find database {name}")
        return name
    for d in os.environ.get("KRAKEN_DB_PATH", ".").split(":"):
        cand = os.path.join(d, name) if d else name
        if os.path.isdir(cand):
            return cand
    if os.path.isdir(name):
        return name
    raise ValueError(f"unable to find database {name} in KRAKEN_DB_PATH")
