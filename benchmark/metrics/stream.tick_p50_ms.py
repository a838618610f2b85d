"""Median wall time of one runner tick: the spans of ``runner.drain()``
calls that ran exactly one tick (the encode, the decode's frame loop and the
partials' copy to the host)."""

import statistics


def read(ctx):
    if ctx.get("kind") != "stream":
        return None
    one = [s for ticks, s, _ in ctx["drains"] if ticks == 1]
    return 1e3 * statistics.median(one) if one else None
