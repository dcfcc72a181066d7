"""Out of core: the chunk tables' copies to the card, milliseconds a
group pass (ooc_timings()["upload"], CUDA events on the copy stream, over
ooc_groups, both summed over the window's samples)."""


def read(ctx):
    n, ups = ctx["counters"]["ooc_groups"], ctx["counters"]["ooc_upload_ms"]
    return sum(ups) / n if n and ups else None
