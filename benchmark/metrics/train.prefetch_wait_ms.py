"""Host milliseconds a window step waited in the program's
``data/prefetch_wait`` span (``data/prefetch.DevicePrefetcher``): the
consumer's wait for its device batch.
None where the program records no such span."""


def read(ctx):
    from rnntransducer_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    if ctx.get("kind") != "train" or not ctx["steps"] or recorded is None:
        return None
    total = recorded().get("data/prefetch_wait")
    return 1e3 * total["host_s"] / len(ctx["steps"]) if total else None
