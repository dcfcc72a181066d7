"""Process start to the window opening: the database (made only on a
checkout's first run), the reads, the Classifier's load and the warm-up."""


def read(ctx):
    return ctx["setup"]["setup_s"]
