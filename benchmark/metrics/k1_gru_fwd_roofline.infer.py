"""K1 (the GRU forward scan) in the transcription window: the least time
its scans could take at each batch's shape and real lengths, over its
kernel time in the trace (%)."""

from benchmark.roofline.kernels import gru_roofline


def read(ctx):
    return gru_roofline(ctx, "infer", backward=False)
