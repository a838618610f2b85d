"""Sequence-parallel (time-sharded) wavefront encoder for long recordings
(port of ``rnntransducer_tpu/parallel/wavefront.py``).

A unidirectional stack's T frames are split into D contiguous chunks, one
per rank of the mesh's ``time`` axis: rank d holds frames [d·T/D,
(d+1)·T/D).  At stage s rank d runs layer l = s − d over its chunk, from
the final (h, c) carry rank d−1 handed it after running the same layer on
the previous chunk, and hands its own carry to rank d+1.  Each rank runs
its layers in order and blocks on the carry it needs, so the staircase
needs no stage counter: a stage at which a rank has no layer launches
nothing.  After D + L − 1 stages every chunk has crossed every layer.

Each chunk scan goes through the recurrent kernels' autograd functions
(``ops.rnn_kernels.GRUScanFunction`` / ``LSTMScanFunction``) with the
received carry as h0 / c0 and the chunk's lengths ``clamp(len − t0, 0,
Tc)``; their backward takes the final carry's cotangent from rank d+1 and
returns dh0 / dc0, which go back to rank d−1.  The layer-0 projection is
hoisted over the chunk.  The carry crosses a chunk boundary in the
activation dtype, as the JAX package's XLA scan carries it (the kernels
carry float32 within a chunk).

The backward is written out (:class:`_Wavefront`): layer by layer from the
last, every rank in the same order, so the carries' cotangents meet their
receivers in the order they are sent.  The stack's param grads are summed
over the time group, the transpose of the JAX ``shard_map``'s replicated
operands, so every rank holds the whole stack's grads.  The final states
(L, 1, B, H) live on rank D−1 and are broadcast; the outputs are
all-gathered along time for the rest of the step, which every time rank
computes alike, and the backward takes this rank's slice of their
cotangent.  Dropout draws one mask per (layer, chunk), matched to
``StackedRNN``'s in distribution, not bit for bit, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from rnntransducer_tpu_torch.models.cells import GATES, RNNState, fast_dropout, layer_scan
from rnntransducer_tpu_torch.parallel.mesh import TIME_AXIS, Mesh, all_reduce_sum, make_mesh


def make_time_mesh() -> Mesh:
    """A mesh whose one non-data axis shards time over every rank of the
    process group."""
    from rnntransducer_tpu_torch.parallel.distributed import world_size
    return make_mesh(sequence_parallel=world_size())


def stack_uni_params(rnn_params: Mapping[str, torch.Tensor], num_layers: int):
    """A unidirectional ``StackedRNN``'s weights (its state-dict entries,
    ``fwd.{l}.w_ih`` ...) as stacked tensors: (w_ih0 (F, G·H), b_ih0,
    w_ih_rest (L-1, H, G·H), b_ih_rest, w_hh (L, H, G·H), b_hh (L, G·H))."""
    p = [{k: rnn_params[f"fwd.{i}.{k}"] for k in ("w_ih", "b_ih", "w_hh", "b_hh")}
         for i in range(num_layers)]
    w_hh0 = p[0]["w_hh"]
    H, GH = w_hh0.shape

    def rest(key, shape):
        if num_layers > 1:
            return torch.stack([q[key] for q in p[1:]])
        return w_hh0.new_zeros((0,) + shape)
    return (p[0]["w_ih"], p[0]["b_ih"], rest("w_ih", (H, GH)), rest("b_ih", (GH,)),
            torch.stack([q["w_hh"] for q in p]), torch.stack([q["b_hh"] for q in p]))


def pad_time_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Right-pad the time axis (axis 1) of (B, T, ...) up to a multiple of
    ``multiple``.  Pad frames sit beyond every row's length, so the masked
    scans ignore them; callers keep the original lengths."""
    pad = (-x.shape[1]) % multiple
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 62-bit draw from ``generator`` (every rank of an axis draws it at
    the same point of its stream, so they agree on it)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def mask_generator(seed: int, key: int, device) -> torch.Generator:
    """The generator of one schedule-local dropout mask: ``seed`` folded
    with ``key`` (a (layer, chunk) or (layer, microbatch) index)."""
    return torch.Generator(device=device).manual_seed(
        (seed + (key + 1) * 0x9E3779B97F4A7C15) % 2 ** 63)


class _Wavefront(torch.autograd.Function):
    """The staircase over this rank's chunk; inputs after ``plan`` and the
    frames are the six tensors of :func:`stack_uni_params`."""

    @staticmethod
    def forward(ctx, plan, x, lengths, *weights):
        rnn_type, L, mesh, dropout, seed, track = plan
        D, d = mesh.size(TIME_AXIS), mesh.index(TIME_AXIS)
        B, T, _ = x.shape
        Tc = T // D
        t0 = d * Tc
        dt, dev = x.dtype, x.device
        lstm = rnn_type == "lstm"
        H = weights[4].shape[1]
        lens = (lengths.to(dev, torch.int64) - t0).clamp(0, Tc)
        w_ih0, b_ih0, w_ih_rest, b_ih_rest, w_hh, b_hh = weights
        # per layer: (w_ih, b_ih, w_hh, b_hh) as leaves of this rank's graphs
        layer_w = [[t.detach().requires_grad_(track and t.requires_grad) for t in (
            w_ih0 if l == 0 else w_ih_rest[l - 1], b_ih0 if l == 0 else b_ih_rest[l - 1],
            w_hh[l], b_hh[l])] for l in range(L)]
        fin_h = torch.zeros((L, B, H), dtype=dt, device=dev)
        fin_c = torch.zeros((L, B, H), dtype=dt, device=dev)
        saved = []
        prev = x[:, t0:t0 + Tc].detach().requires_grad_(track and x.requires_grad)
        with torch.set_grad_enabled(track):
            for l in range(L):
                if d > 0:
                    h0 = mesh.recv((B, H), dt, dev, TIME_AXIS, d - 1).requires_grad_(track)
                    c0 = (mesh.recv((B, H), dt, dev, TIME_AXIS, d - 1).requires_grad_(track)
                          if lstm else None)
                else:
                    h0 = torch.zeros((B, H), dtype=dt, device=dev)
                    c0 = torch.zeros((B, H), dtype=dt, device=dev) if lstm else None
                inp = prev if l == 0 else prev.detach().requires_grad_(track)
                y = inp
                if l > 0 and dropout > 0.0:
                    y = fast_dropout(inp, dropout, mask_generator(seed, l * D + d, dev))
                w_ih, b_ih, w_hh_l, b_hh_l = layer_w[l]
                xw = (torch.matmul(y, w_ih) + b_ih).to(dt).transpose(0, 1).contiguous()
                outs, hf, cf = layer_scan(rnn_type, xw, w_hh_l, b_hh_l, h0, c0, lens)
                out = outs.transpose(0, 1)
                if d < D - 1:
                    mesh.send(hf, TIME_AXIS, d + 1)
                    if lstm:
                        mesh.send(cf, TIME_AXIS, d + 1)
                else:
                    fin_h[l] = hf.detach()
                    if lstm:
                        fin_c[l] = cf.detach()
                if track:
                    saved.append((inp, h0, c0, out, hf, cf))
                prev = out
        ctx.plan, ctx.saved, ctx.layer_w = plan, saved, layer_w
        ctx.shapes = (B, T, Tc, t0, H, dt, x.requires_grad)
        ctx.weight_shapes = [(w.shape, w.dtype) for w in weights]
        out = mesh.all_gather(prev.detach(), TIME_AXIS, 1)
        mesh.broadcast(fin_h, TIME_AXIS, D - 1)
        if lstm:
            mesh.broadcast(fin_c, TIME_AXIS, D - 1)
        return out, fin_h, fin_c

    @staticmethod
    def backward(ctx, g_out, g_fh, g_fc):
        rnn_type, L, mesh, _, _, _ = ctx.plan
        D, d = mesh.size(TIME_AXIS), mesh.index(TIME_AXIS)
        B, T, Tc, t0, H, dt, x_grad = ctx.shapes
        dev = g_out.device
        lstm = rnn_type == "lstm"
        g_next = g_out[:, t0:t0 + Tc].contiguous()
        g_layer: List[List[Optional[torch.Tensor]]] = [None] * L
        g_x = None
        for l in range(L - 1, -1, -1):
            inp, h0, c0, out, hf, cf = ctx.saved[l]
            if d < D - 1:
                g_hf = mesh.recv((B, H), dt, dev, TIME_AXIS, d + 1)
                g_cf = mesh.recv((B, H), dt, dev, TIME_AXIS, d + 1) if lstm else None
            else:
                g_hf = torch.zeros_like(hf) if g_fh is None else g_fh[l].to(dt)
                g_cf = (None if not lstm else torch.zeros_like(cf) if g_fc is None
                        else g_fc[l].to(dt))
            outputs = [out, hf] + ([cf] if lstm else [])
            cots = [g_next, g_hf] + ([g_cf] if lstm else [])
            carries = [h0] + ([c0] if lstm else []) if d > 0 else []
            wanted = [inp] if inp.requires_grad else []
            wanted += carries + [w for w in ctx.layer_w[l] if w.requires_grad]
            res = list(torch.autograd.grad(outputs, wanted, cots, allow_unused=True))
            g_inp = res.pop(0) if inp.requires_grad else None
            if d > 0:
                for g, c in zip(res[:len(carries)], carries):
                    mesh.send(torch.zeros_like(c) if g is None else g, TIME_AXIS, d - 1)
                res = res[len(carries):]
            g_layer[l] = [res.pop(0) if w.requires_grad else None for w in ctx.layer_w[l]]
            if l > 0:
                g_next = g_inp
            else:
                g_x = g_inp
        ctx.saved = None

        def stacked(j, layers, k):
            shape, dtype = ctx.weight_shapes[k]
            if not layers:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return torch.stack([torch.zeros(shape[1:], dtype=dtype, device=dev)
                                if g_layer[l][j] is None else g_layer[l][j] for l in layers])

        def first(j, k):
            shape, dtype = ctx.weight_shapes[k]
            g = g_layer[0][j]
            return torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
        grads = [first(0, 0), first(1, 1), stacked(0, range(1, L), 2),
                 stacked(1, range(1, L), 3), stacked(2, range(L), 4),
                 stacked(3, range(L), 5)]
        # the replicated stack's grads: every chunk's share, summed over time
        if mesh.size(TIME_AXIS) > 1:
            for dtype in {g.dtype for g in grads}:
                all_reduce_sum([g for g in grads if g.dtype == dtype],
                               mesh.group(TIME_AXIS))
        full_x = None
        if x_grad:
            full_x = g_out.new_zeros((B, T) + tuple(g_x.shape[2:]))
            full_x[:, t0:t0 + Tc] = g_x
            mesh.all_reduce(full_x, TIME_AXIS)
        return (None, full_x, None) + tuple(grads)


def wavefront_scan(rnn_params: Mapping[str, torch.Tensor], x: torch.Tensor,
                   lengths: torch.Tensor, *, rnn_type: str, num_layers: int, mesh: Mesh,
                   dropout: float = 0.0, generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, RNNState]:
    """Run a unidirectional ``StackedRNN`` (its state-dict entries
    ``fwd.{l}.*``) over ``x`` (B, T, F), time-sharded over ``mesh``'s
    ``time`` axis with the wavefront schedule; T must divide by the axis
    width (:func:`pad_time_to_multiple`); ``lengths`` (B,) are the true
    frame counts.  Returns (outputs (B, T, H) on every rank, RNNState (L, 1,
    B, H)), equal to ``StackedRNN`` without dropout.  ``dropout > 0`` (with
    ``generator``) drops the input of layers 1..L-1, one mask per (layer,
    chunk)."""
    rnn_type = rnn_type.lower()
    if rnn_type not in GATES:
        raise ValueError(f"unknown rnn_type {rnn_type!r}")
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout > 0 needs dropout_rng")
    D = mesh.size(TIME_AXIS)
    T = x.shape[1]
    if T % D:
        raise ValueError(f"T={T} not divisible by time-mesh width {D}; "
                         "pad with pad_time_to_multiple")
    seed = draw_seed(generator) if dropout > 0.0 else 0
    weights = stack_uni_params(rnn_params, num_layers)
    # build the per-chunk graphs only where a backward will read them
    track = torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in weights))
    out, fin_h, fin_c = _Wavefront.apply(
        (rnn_type, num_layers, mesh, dropout, seed, track), x, lengths, *weights)
    return out, RNNState(fin_h[:, None], fin_c[:, None] if rnn_type == "lstm" else None)


def wavefront_encode(encoder_params: Mapping[str, torch.Tensor], cfg, x: torch.Tensor,
                     lengths: torch.Tensor, mesh: Mesh, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, RNNState]:
    """``AudioEncoder`` forward (the rnn stack and the output projection)
    over a time axis.  ``encoder_params``: the encoder's state-dict entries
    (``rnn.fwd.0.w_ih`` ...); ``cfg``: its TransNetConfig (unidirectional);
    ``x``: (B, T, n_mels) log-mel frames, T divisible by the axis width.
    Returns ((B, T, output_size), RNNState), equal to ``AudioEncoder``
    without dropout."""
    if cfg.bidirectional:
        raise ValueError(
            "wavefront sequence parallelism needs a unidirectional encoder: "
            "a bidirectional layer's successor consumes the full backward "
            "sweep, so time chunks cannot pipeline (docs/TUNING.md)")
    if cfg.time_reduction_stride > 1:
        raise ValueError(
            "wavefront sequence parallelism does not support time reduction "
            "(the layer split + per-chunk frame stacking is not implemented "
            "for the staircase schedule); use time_reduction_stride=1")
    rnn = {k[len("rnn."):]: v for k, v in encoder_params.items() if k.startswith("rnn.")}
    outs, state = wavefront_scan(rnn, x, lengths, rnn_type=cfg.rnn_type,
                                 num_layers=cfg.num_layers, mesh=mesh, dropout=dropout,
                                 generator=generator)
    return (F.linear(outs, encoder_params["out_proj.weight"],
                     encoder_params["out_proj.bias"]), state)


__all__ = ["TIME_AXIS", "make_time_mesh", "pad_time_to_multiple", "stack_uni_params", "wavefront_encode",
           "wavefront_scan"]
