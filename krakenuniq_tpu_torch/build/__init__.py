"""Database construction: the reference's build pipeline (db_sort, set_lcas,
db_shrink, UID builds -- scripts/build_db.sh steps 1-6) as one vectorized
host/device pass over the library."""

from .db_build import BuildResult, build_database, expand_dynamic_taxids, shrink_pairs

__all__ = ["BuildResult", "build_database", "expand_dynamic_taxids", "shrink_pairs"]
