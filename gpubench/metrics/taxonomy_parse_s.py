"""Set-up's taxDB parse, seconds: the "load.taxonomy" span
(Taxonomy.from_taxdb_file) under set-up's "load" root."""

from gpubench.metrics import _spans


def read(ctx):
    return _spans.setup_child(ctx, "load.taxonomy")
