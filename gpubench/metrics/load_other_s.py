"""The Classifier's construction beyond its tables: the taxonomy parse,
the value pool and the configuration."""


def read(ctx):
    return ctx["setup"]["load_s"] - ctx["setup"]["load_tables_s"]
