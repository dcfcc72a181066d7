"""Reads classified in the window over the whole window: every sample's
classification and its report, from the first sample's start to the last
report written (host clock). A per-layer metric: the report under it
wanders with the host by more than an end-to-end bound can hold."""


def read(ctx):
    return ctx["window"]["reads"] / ctx["window"]["seconds"]
