"""torch.cuda.max_memory_allocated() from set-up through the window, GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
