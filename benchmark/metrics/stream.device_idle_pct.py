"""Share of the traced streaming window in which no device activity ran
(%)."""

from benchmark.harness.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.get("trace")) if ctx.get("kind") == "stream" else None
