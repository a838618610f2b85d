"""Share of the traced training window in which no device activity ran:
the complement of the union of kernel, copy and set intervals (%)."""

from benchmark.harness.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.get("trace")) if ctx.get("kind") == "train" else None
