"""Device milliseconds a window step spent in the program's ``train/encoder``
span (``train/state.loss_fn``): the encoder's forward.
None where the program records no such span."""


def read(ctx):
    from rnntransducer_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    if ctx.get("kind") != "train" or not ctx["steps"] or recorded is None:
        return None
    total = recorded().get("train/encoder")
    return 1e3 * total["device_s"] / len(ctx["steps"]) if total else None
