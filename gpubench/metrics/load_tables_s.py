"""The database tables' load: the sum of DeviceDB.timings (or, out of
core, ChunkedHashDB.timings): the kdb read, the cache read or the build,
the upload or the pinning."""


def read(ctx):
    return ctx["setup"]["load_tables_s"]
