"""K2 (the GRU backward scan: its gates GEMM and chain) in the training
window: the least time at its shapes and real lengths over its kernels'
time in the trace (%)."""

from benchmark.roofline.kernels import gru_roofline


def read(ctx):
    return gru_roofline(ctx, "train", backward=True)
