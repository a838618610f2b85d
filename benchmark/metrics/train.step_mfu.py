"""Model FLOPs of the window's training steps, every row at its own frame
and label counts, over the window's wall time and the card's bf16 peak (%)."""

from benchmark.roofline.counts import PEAK_FLOPS, train_step_flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    flops = sum(train_step_flops(ctx["model"], s["frames"], s["labels"])
                for s in ctx["steps"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS[ctx["precision"]])
