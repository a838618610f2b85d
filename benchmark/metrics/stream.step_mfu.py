"""Forward model FLOPs of the window's streamed chunks (the real frames of
its lanes through the chunked-causal encoder, and the prediction network
and joint for the labels emitted) over the window's wall time and the
card's bf16 peak (%)."""

from benchmark.roofline.counts import PEAK_FLOPS, decode_flops


def read(ctx):
    if ctx.get("kind") != "stream" or ctx["window_s"] <= 0 or not ctx["frames"]:
        return None
    tn = ctx["model"]["transnet"]
    keys = tn.get("attention_chunk", 0) * (tn.get("attention_left_chunks", 0) + 1)
    flops = decode_flops(ctx["model"], ctx["frames"], ctx["tokens"], keys)
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS[ctx["precision"]])
