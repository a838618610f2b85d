"""Forward model FLOPs of the window's transcriptions at their real lengths
(the encoder over every utterance's frames, the joint per frame, the
prediction network and joint per served label) over the window's wall time
and the card's bf16 peak (%)."""

from benchmark.roofline.counts import PEAK_FLOPS, decode_flops


def read(ctx):
    if ctx.get("kind") != "infer" or ctx["window_s"] <= 0 or not ctx["frames"]:
        return None
    flops = decode_flops(ctx["model"], ctx["frames"], ctx["tokens"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS[ctx["precision"]])
