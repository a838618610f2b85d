"""GPipe pipeline parallelism for the encoder stack (port of
``rnntransducer_tpu/parallel/pipeline.py``).

The L stacked layers are split over the mesh's ``stage`` axis: stage s
owns layers [s·L/D, (s+1)·L/D) in both directions.  M microbatches stream
through the stages: stage s runs microbatch m at tick t = s + m and hands
its activations (bm, T, dirs·H) to stage s+1.  After M + D − 1 ticks every
microbatch has crossed every layer; the bubble fraction is (D−1)/(M+D−1).
Each stage runs its layers over the microbatch's full T frames (a forward
scan and a reversed one), so the schedule is exact for bidirectional
stacks.  A stage receives microbatch m, runs it and sends it on, in order,
so it waits for its first microbatch for s ticks and is done M + s ticks
later: the bubble ticks launch nothing, where the JAX package's uniform
program computes them and throws them away.

One process per stage needs no uniform program either, so layer 0 keeps
its own input width (the JAX package pads it to dirs·H); the refusals of
that layout stay, with the JAX package's texts.  The params stay whole on
every rank, as in the JAX Trainer: the compute and the activations are
what the stages split.

The backward is written out (:class:`_Pipeline`): microbatches from the
last to the first on every stage, each taking its output cotangent from
stage s+1 (the last stage from the step's) and sending its input
cotangent to stage s−1, so the neighbours' sends and receives pair up in
order.  The last stage's output is broadcast to every stage rank, as the
JAX package's masked ``psum`` does; the rest of the step runs replicated.
A layer's param grads come out on the one stage that owns it (zero
elsewhere): the train step sums them over the stage group.  Dropout draws
one mask per (layer, microbatch), matched to ``StackedRNN``'s in
distribution, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.models.cells import GATES, fast_dropout, layer_scan
from rnntransducer_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh, make_mesh
from rnntransducer_tpu_torch.parallel.wavefront import draw_seed, mask_generator

_KEYS = ("w_ih", "b_ih", "w_hh", "b_hh")


def make_stage_mesh() -> Mesh:
    """A mesh whose one non-data axis shards the layer stack over every rank
    of the process group."""
    from rnntransducer_tpu_torch.parallel.distributed import world_size
    return make_mesh(pipeline_stages=world_size())


def stack_pipeline_params(rnn_params: Mapping[str, torch.Tensor], num_layers: int,
                          bidirectional: bool
                          ) -> Tuple[List[Dict[str, torch.Tensor]],
                                     Optional[List[Dict[str, torch.Tensor]]], int]:
    """The stage pipeline's weights per direction: a list over layers of
    {w_ih, b_ih, w_hh, b_hh} from a ``StackedRNN``'s state-dict entries
    (``fwd.{l}.w_ih`` ...), and the uniform layer width ``d_in = dirs·H``.
    Returns (fwd, bwd-or-None, d_in); refuses an ``input_size`` above
    d_in, as the JAX package's uniform-stage layout does."""
    dirs = ["fwd", "bwd"] if bidirectional else ["fwd"]
    per_dir = {d: [{k: rnn_params[f"{d}.{i}.{k}"] for k in _KEYS}
                   for i in range(num_layers)] for d in dirs}
    h = per_dir["fwd"][0]["w_hh"].shape[0]
    d_in = len(dirs) * h
    f = per_dir["fwd"][0]["w_ih"].shape[0]
    if f > d_in:
        raise ValueError(
            f"pipeline stages need input_size ({f}) <= dirs*hidden "
            f"({d_in}): layer 0's projection is padded UP to the uniform "
            "layer width")
    return per_dir["fwd"], per_dir.get("bwd"), d_in


def _run_stage(plan, inp, lengths, weights, mb):
    """This stage's layers over one microbatch (B, T, F): per layer, the
    input dropout (global layers > 0), then the forward scan and, when
    bidirectional, the reversed one."""
    rnn_type, first, n_layers, dirs, _, M, dropout, seed, _ = plan
    B = inp.shape[0]
    y = inp
    for j in range(n_layers):
        layer = first + j
        if layer > 0 and dropout > 0.0:
            y = fast_dropout(y, dropout, mask_generator(seed, layer * M + mb, y.device))
        outs = []
        for k in range(dirs):
            w_ih, b_ih, w_hh, b_hh = weights[(j * dirs + k) * 4:(j * dirs + k + 1) * 4]
            xw = (torch.matmul(y, w_ih) + b_ih).to(inp.dtype).transpose(0, 1).contiguous()
            z = torch.zeros((B, w_hh.shape[0]), dtype=inp.dtype, device=inp.device)
            o, _, _ = layer_scan(rnn_type, xw, w_hh, b_hh, z,
                                 z if rnn_type == "lstm" else None,
                                 lengths.clamp(0, xw.shape[0]), reverse=k == 1)
            outs.append(o.transpose(0, 1))
        y = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
    return y


class _Pipeline(torch.autograd.Function):
    """This stage's share of the GPipe schedule; inputs after ``plan`` and
    the frames are this stage's layers' weights, per layer and direction
    (w_ih, b_ih, w_hh, b_hh)."""

    @staticmethod
    def forward(ctx, plan, x, lengths, *weights):
        _, _, _, dirs, mesh, M, _, _, track = plan
        D, s = mesh.size(STAGE_AXIS), mesh.index(STAGE_AXIS)
        B, T, _ = x.shape
        bm = B // M
        width = dirs * weights[2].shape[0]
        dt, dev = x.dtype, x.device
        leaves = [w.detach().requires_grad_(track and w.requires_grad) for w in weights]
        lengths = lengths.to(dev, torch.int64)
        saved, outs = [], []
        for mb in range(M):
            rows = slice(mb * bm, (mb + 1) * bm)
            if s == 0:
                inp = x[rows].detach().requires_grad_(track and x.requires_grad)
            else:
                inp = mesh.recv((bm, T, width), dt, dev, STAGE_AXIS,
                                s - 1).requires_grad_(track)
            with torch.set_grad_enabled(track):
                y = _run_stage(plan, inp, lengths[rows], leaves, mb)
            if s < D - 1:
                mesh.send(y, STAGE_AXIS, s + 1)
            else:
                outs.append(y.detach())
            if track:
                saved.append((inp, y))
        out = torch.cat(outs) if s == D - 1 else torch.empty((B, T, width), dtype=dt,
                                                              device=dev)
        mesh.broadcast(out, STAGE_AXIS, D - 1)
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        ctx.x_shape = (B, T, x.shape[2], bm, width, dt, x.requires_grad)
        return out

    @staticmethod
    def backward(ctx, g_out):
        _, _, _, _, mesh, M, _, _, _ = ctx.plan
        D, s = mesh.size(STAGE_AXIS), mesh.index(STAGE_AXIS)
        B, T, F_in, bm, width, dt, x_grad = ctx.x_shape
        dev = g_out.device
        wanted_w = [w for w in ctx.leaves if w.requires_grad]
        g_w: List[Optional[torch.Tensor]] = [None] * len(wanted_w)
        g_x = g_out.new_zeros((B, T, F_in)) if x_grad else None
        for mb in range(M - 1, -1, -1):
            rows = slice(mb * bm, (mb + 1) * bm)
            inp, y = ctx.saved[mb]
            g_y = (g_out[rows].to(dt).contiguous() if s == D - 1
                   else mesh.recv((bm, T, width), dt, dev, STAGE_AXIS, s + 1))
            wanted = ([inp] if inp.requires_grad else []) + wanted_w
            res = list(torch.autograd.grad(y, wanted, g_y, allow_unused=True))
            if inp.requires_grad:
                g_inp = res.pop(0)
                g_inp = torch.zeros_like(inp) if g_inp is None else g_inp
                if s > 0:
                    mesh.send(g_inp, STAGE_AXIS, s - 1)
                else:
                    g_x[rows] = g_inp
            g_w = [a if b is None else b if a is None else a + b for a, b in zip(g_w, res)]
        ctx.saved = None
        it = iter(g_w)
        grads = tuple((next(it) if w.requires_grad else None) for w in ctx.leaves)
        return (None, g_x, None) + grads


def pipeline_scan(rnn_params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  lengths: torch.Tensor, *, rnn_type: str, num_layers: int,
                  bidirectional: bool, mesh: Mesh, num_microbatches: int,
                  dropout: float = 0.0, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Run a ``StackedRNN`` (its state-dict entries ``fwd.{l}.*`` /
    ``bwd.{l}.*``) over ``mesh``'s ``stage`` axis with the GPipe schedule.
    ``x``: (B, T, F); ``lengths``: (B,).  B must divide into
    ``num_microbatches`` and L into the axis width.  Returns the stack
    output (B, T, dirs·H) on every stage rank, equal to ``StackedRNN``
    without dropout.  ``dropout > 0`` (with ``generator``) drops every
    layer's input but layer 0's, one mask per (layer, microbatch).  The
    param grads of a layer come out on its own stage only."""
    rnn_type = rnn_type.lower()
    if rnn_type not in GATES:
        raise ValueError(f"unknown rnn_type {rnn_type!r}")
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout > 0 needs dropout_rng")
    D = mesh.size(STAGE_AXIS)
    L, M = num_layers, num_microbatches
    if L % D:
        raise ValueError(f"num_layers={L} not divisible by stage-mesh "
                         f"width {D}")
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by num_microbatches {M}")
    fwd, bwd, _ = stack_pipeline_params(rnn_params, L, bidirectional)
    lps = L // D
    first = mesh.index(STAGE_AXIS) * lps
    dirs = [fwd] + ([bwd] if bidirectional else [])
    weights = [d[layer][k] for layer in range(first, first + lps) for d in dirs
               for k in _KEYS]
    seed = draw_seed(generator) if dropout > 0.0 else 0
    # build the per-microbatch graphs only where a backward will read them
    track = torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in weights))
    plan = (rnn_type, first, lps, len(dirs), mesh, M, dropout, seed, track)
    return _Pipeline.apply(plan, x, lengths, *weights)


def pipeline_encode(encoder_params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
                    lengths: torch.Tensor, mesh: Mesh, num_microbatches: int,
                    dropout: float = 0.0, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """``AudioEncoder`` forward (the rnn stack and the output projection)
    over a stage axis.  ``encoder_params``: the encoder's state-dict entries
    (``rnn.fwd.0.w_ih`` ...); ``cfg``: its TransNetConfig; ``x``: (B, T,
    n_mels) log-mel frames.  Returns (B, T, output_size), equal to
    ``AudioEncoder`` without dropout."""
    if cfg.time_reduction_stride > 1:
        raise ValueError(
            "stage pipelining does not support time reduction (the "
            "mid-stack width change breaks the uniform-stage SPMD program);"
            " use time_reduction_stride=1")
    rnn = {k[len("rnn."):]: v for k, v in encoder_params.items() if k.startswith("rnn.")}
    outs = pipeline_scan(rnn, x, lengths, rnn_type=cfg.rnn_type,
                         num_layers=cfg.num_layers, bidirectional=cfg.bidirectional,
                         mesh=mesh, num_microbatches=num_microbatches, dropout=dropout,
                         generator=generator)
    return F.linear(outs, encoder_params["out_proj.weight"], encoder_params["out_proj.bias"])


__all__ = ["STAGE_AXIS", "make_stage_mesh", "pipeline_encode", "pipeline_scan", "stack_pipeline_params"]
