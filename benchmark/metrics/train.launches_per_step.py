"""CUDA kernel launches in the traced window per training step."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or not trace or not trace["launches"] or not ctx["steps"]:
        return None
    return trace["launches"] / len(ctx["steps"])
