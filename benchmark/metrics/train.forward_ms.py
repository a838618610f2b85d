"""Device milliseconds a window step spent in the program's ``train/forward``
spans (``train/state.train_step``): the weights' cast and noise, the
frontend, the encoder, the prediction net, the joint and the loss.
None where the program records no such span."""


def read(ctx):
    from rnntransducer_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    if ctx.get("kind") != "train" or not ctx["steps"] or recorded is None:
        return None
    total = recorded().get("train/forward")
    return 1e3 * total["device_s"] / len(ctx["steps"]) if total else None
