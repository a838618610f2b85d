"""Mean milliseconds a training step waited for its device batch: the
harness's span around the fetch from ``DevicePrefetcher``."""


def read(ctx):
    waits = ctx.get("spans", {}).get("feed_wait") if ctx.get("kind") == "train" else None
    return 1e3 * sum(waits) / len(waits) if waits else None
