"""Conformer encoder (port of ``rnntransducer_tpu/models/conformer.py``),
selected with ``transnet.arch="conformer"``.

Macaron blocks (Gulati et al. 2020): ``x += 1/2 FFN(LN x); x += MHSA(LN x);
x += Conv(LN x); x += 1/2 FFN(LN x); x = LN(x)``, with rotary position
embeddings on q / k, a GLU + depthwise conv module, frame stacking
(``time_reduction_stride``) on the input features and an output
projection.  Two context modes, as in the JAX module:

* ``attention_chunk == 0``: full-context attention, offline only;
* ``attention_chunk == C > 0``: chunked-causal attention (frame t attends
  to its own C-frame chunk and ``attention_left_chunks`` chunks before it)
  and a causal conv.  Training and offline decode use the masked forward;
  streaming (``initial_state`` given) runs one C-frame chunk per call
  against a per-block cache and equals the masked forward: ``RNNState.h``
  (L, left*C, B, d+1) holds each block's pre-norm attention input window
  plus a validity flag channel, ``RNNState.c`` (L, K-1, B, d) the conv
  module's post-GLU tail.

Numerics follow the JAX module: flax's LayerNorm (eps 1e-6, the
variance as E[x^2] - E[x]^2 in float32), the
half-split RoPE with queries at offset ``Tk - Tq``, attention logits and
softmax in float32 with masked entries set to ``NEG`` (a row with every
key masked gives a uniform softmax, not NaN), the softmax cast back to the
activation dtype before the value product.  The depthwise conv is K
shifted multiply-adds with the JAX module's shift-structured backward
(``DepthwiseConv1dFunction``).  Flax's ``scan_blocks`` / ``scan_block_group``
only choose the param layout the weight bridge reads: the port's blocks
are always separate modules.  ``cfg.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``), replaying the block's dropout
draws from a snapshot of the generator.

Dropout (training only: a ``generator`` is passed) follows ``FastDropout``
at the JAX module's sites: once after the input projection and seven
times per block.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rnntransducer_tpu_torch.config import TransNetConfig
from rnntransducer_tpu_torch.models.cells import RNNState, fast_dropout, remat_active
from rnntransducer_tpu_torch.models.encoder import stack_frames
from rnntransducer_tpu_torch.utils.masking import length_mask

NEG = -1e30
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm``: float32 statistics, the variance as E[x^2] -
    E[x]^2 clipped at 0, then (x - mean) * (rsqrt(var + eps) * scale) +
    bias, cast back to x's dtype.  (``F.layer_norm``'s two-pass variance
    moves the fp32 grads of two blocks by ~1e-5 of their largest.)"""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * norm.weight)
    return (y + norm.bias).to(x.dtype)


def rope(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Rotary position embedding over (B, H, T, hd): the half-split form,
    feature i of the first half paired with feature i of the second, at
    angle (t + offset) * 10000^(-i / half); an odd last feature passes
    through unrotated."""
    T, hd = x.shape[2], x.shape[3]
    half = hd // 2
    inv = torch.from_numpy(
        (10000.0 ** (-np.arange(0, half) / half)).astype(np.float32)).to(x.device)
    pos = torch.arange(T, dtype=torch.float32, device=x.device) + float(offset)
    ang = pos[:, None] * inv[None, :]                       # (T, half)
    sin, cos = torch.sin(ang).to(x.dtype), torch.cos(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    if hd % 2:
        rot = torch.cat([rot, x[..., -1:]], -1)
    return rot


def dwconv_valid_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID 1-D conv as K shifted multiply-adds:
    out[:, t] = sum_i x[:, t + i] * k[i].  x (B, Tp, D), k (K, D)."""
    K = k.shape[0]
    t_out = x.shape[1] - K + 1
    out = x[:, 0:t_out] * k[0]
    for i in range(1, K):
        out = out + x[:, i:i + t_out] * k[i]
    return out


class DepthwiseConv1dFunction(torch.autograd.Function):
    """``dwconv_valid_reference`` with the JAX module's hand-written VJP
    (``_dwconv_valid_bwd``): dx is the full correlation of the zero-padded
    cotangent with the reversed kernel, dk is K reductions in float32."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return dwconv_valid_reference(x, k)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        K, t_out, t_in = k.shape[0], g.shape[1], x.shape[1]
        gp = F.pad(g, (0, 0, K - 1, K - 1))
        dx = gp[:, K - 1:K - 1 + t_in] * k[0]
        for i in range(1, K):
            dx = dx + gp[:, K - 1 - i:K - 1 - i + t_in] * k[i]
        dk = torch.stack([(g * x[:, i:i + t_out]).float().sum(dim=(0, 1))
                          for i in range(K)]).to(k.dtype)
        return dx, dk


class FeedForward(nn.Module):
    """LN -> Dense(mult*d) -> swish -> dropout -> Dense(d) -> dropout (flax
    names ``LayerNorm_0``, ``Dense_0``, ``Dense_1``)."""

    def __init__(self, d_model: int, mult: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm = nn.LayerNorm(d_model)
        self.dense0 = nn.Linear(d_model, mult * d_model)
        self.dense1 = nn.Linear(mult * d_model, d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = F.silu(self.dense0(_layer_norm(self.norm, x)))
        x = fast_dropout(x, self.dropout, generator)
        return fast_dropout(self.dense1(x), self.dropout, generator)


class SelfAttention(nn.Module):
    """Pre-norm multi-head self-attention with RoPE.  ``xkv`` may extend
    ``xq`` on the left (the streaming window): queries sit at positions
    ``Tk - Tq .. Tk - 1`` of the key timeline."""

    def __init__(self, d_model: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.norm = nn.LayerNorm(d_model)
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, xq, xkv, mask, generator: Optional[torch.Generator] = None):
        """xq (B, Tq, D), xkv (B, Tk, D) pre-norm streams; mask (B or 1, Tq,
        Tk) bool, True = may attend."""
        B, Tq, D = xq.shape
        Tk = xkv.shape[1]
        H = self.num_heads
        hd = D // H
        q_in = _layer_norm(self.norm, xq)
        kv_in = _layer_norm(self.norm, xkv)

        def heads(t):
            return t.reshape(B, -1, H, hd).transpose(1, 2)

        q = rope(heads(self.q_proj(q_in)), offset=Tk - Tq)
        k = rope(heads(self.k_proj(kv_in)), offset=0)
        v = heads(self.v_proj(kv_in))
        # float32 scores (exact products of bf16 inputs, float32 sums)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG))
        att = torch.softmax(logits, dim=-1).to(xq.dtype)
        att = fast_dropout(att, self.dropout, generator)
        o = torch.matmul(att, v).transpose(1, 2).reshape(B, Tq, D)
        return fast_dropout(self.out(o), self.dropout, generator)


class DepthwiseConv1D(nn.Module):
    """Depthwise VALID conv; ``weight`` keeps flax ``nn.Conv``'s (K, 1, D)."""

    def __init__(self, features: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_size, 1, features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        k = self.weight[:, 0].to(x.dtype)
        return DepthwiseConv1dFunction.apply(x, k) + self.bias.to(x.dtype)


class ConvModule(nn.Module):
    """LN -> pointwise(2d) -> GLU -> depthwise conv -> LN -> swish ->
    pointwise(d) -> dropout.  Padded positions are zeroed after the first
    LN and after the GLU; ``causal`` pads K-1 on the left, else "same"
    padding; streaming passes the carried post-GLU ``tail`` (B, K-1, d)
    and gets the new one back."""

    def __init__(self, d_model: int, kernel_size: int, dropout: float,
                 causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.dropout = dropout
        self.causal = causal
        self.norm = nn.LayerNorm(d_model)
        self.pre = nn.Linear(d_model, 2 * d_model)
        self.conv = DepthwiseConv1D(d_model, kernel_size)
        self.post_norm = nn.LayerNorm(d_model)
        self.post = nn.Linear(d_model, d_model)

    def forward(self, x, valid, generator: Optional[torch.Generator] = None,
                tail: Optional[torch.Tensor] = None):
        K = self.kernel_size
        keep = valid[..., None]
        x = torch.where(keep, _layer_norm(self.norm, x), 0.0)
        a, b = self.pre(x).chunk(2, dim=-1)
        x = torch.where(keep, a * torch.sigmoid(b), 0.0)     # GLU
        new_tail = None
        if tail is not None:                                 # streaming
            win = torch.cat([tail.to(x.dtype), x], dim=1)
            new_tail = win[:, win.shape[1] - (K - 1):]
            x = self.conv(win)
        elif self.causal:
            x = self.conv(F.pad(x, (0, 0, K - 1, 0)))
        else:
            lp = (K - 1) // 2
            x = self.conv(F.pad(x, (0, 0, lp, K - 1 - lp)))
        x = self.post(F.silu(_layer_norm(self.post_norm, x)))
        return fast_dropout(x, self.dropout, generator), new_tail


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_mult: int,
                 kernel_size: int, dropout: float, causal: bool = False):
        super().__init__()
        self.ff1 = FeedForward(d_model, ff_mult, dropout)
        self.attn = SelfAttention(d_model, num_heads, dropout)
        self.conv = ConvModule(d_model, kernel_size, dropout, causal)
        self.ff2 = FeedForward(d_model, ff_mult, dropout)
        self.final_norm = nn.LayerNorm(d_model)

    def forward(self, x, valid, mask, generator: Optional[torch.Generator] = None):
        """Offline forward.  mask: (B or 1, T, T) attention mask."""
        x = x + 0.5 * self.ff1(x, generator)
        x = x + self.attn(x, x, mask, generator)
        x = x + self.conv(x, valid, generator)[0]
        x = x + 0.5 * self.ff2(x, generator)
        return _layer_norm(self.final_norm, x)

    def stream(self, x, valid, cache_x1, conv_tail,
               generator: Optional[torch.Generator] = None):
        """One chunk against the cache.  x (B, S, D) block input, valid (B,
        S), cache_x1 (B, ctx, D+1) earlier x1 rows + validity flag,
        conv_tail (B, K-1, D).  Returns (out, new_cache_x1, new_tail)."""
        S, D = x.shape[1], x.shape[2]
        x1 = x + 0.5 * self.ff1(x, generator)
        x1f = torch.cat([x1, valid.to(x1.dtype)[..., None]], dim=-1)
        win = torch.cat([cache_x1.to(x1f.dtype), x1f], dim=1)
        new_cache = win[:, S:]                               # the last ctx rows
        mask = (win[..., -1] > 0.5)[:, None, :]              # every query row
        x2 = x1 + self.attn(x1, win[..., :D], mask, generator)
        c, new_tail = self.conv(x2, valid, generator, tail=conv_tail)
        x3 = x2 + c
        x4 = x3 + 0.5 * self.ff2(x3, generator)
        return _layer_norm(self.final_norm, x4), new_cache, new_tail


def _remat_block(block: ConformerBlock, x, valid, mask,
                 generator: Optional[torch.Generator]):
    """``block(x, valid, mask, generator)`` recomputed in the backward pass.
    The recompute runs on the params the forward saw (under
    ``functional_call`` those are the cast copies, not the module's own) and
    replays the forward's dropout draws from a copy of the generator taken
    at block entry, leaving the generator itself where the forward left
    it."""
    params = dict(block.named_parameters())
    start = None if generator is None else generator.get_state()
    calls = [0]

    def run(x):
        calls[0] += 1
        gen = generator
        if calls[0] > 1 and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        return torch.func.functional_call(block, params, (x, valid, mask, gen))

    return checkpoint(run, x, use_reentrant=False)


class ConformerEncoder(nn.Module):
    """The ``AudioEncoder`` interface: ``forward(inputs, lengths,
    initial_state, generator)`` -> ((B, T', output_size), state) with T' =
    ``cfg.output_frames(T)``.  Streaming (``initial_state`` with cache
    rows) needs ``attention_chunk > 0`` and one C-frame chunk (after
    reduction) per call."""

    def __init__(self, cfg: TransNetConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.in_proj = nn.Linear(cfg.input_size * max(cfg.time_reduction_stride, 1), d)
        self.blocks = nn.ModuleList(
            ConformerBlock(d, cfg.attention_heads, cfg.ff_multiplier,
                           cfg.conv_kernel_size, cfg.dropout,
                           causal=cfg.attention_chunk > 0)
            for _ in range(cfg.num_layers))
        self.out_proj = nn.Linear(d, cfg.output_size)

    def _chunk_mask(self, T: int, device) -> Optional[torch.Tensor]:
        """(1, T, T) block-causal chunk mask (True = may attend), or None
        for full context."""
        C = self.cfg.attention_chunk
        if C <= 0:
            return None
        ci = torch.arange(T, device=device) // C
        d = ci[:, None] - ci[None, :]                        # cq - ck
        return ((d >= 0) & (d <= self.cfg.attention_left_chunks))[None]

    def _project_in(self, inputs, lengths, generator):
        """Zero frames past each length, stack, project: (x, valid)."""
        cfg = self.cfg
        T = inputs.shape[1]
        inputs = torch.where(length_mask(lengths, T)[..., None], inputs, 0.0)
        x = stack_frames(inputs, cfg.time_reduction_stride)
        valid = length_mask(cfg.output_lengths(lengths.to(torch.int64)), x.shape[1])
        return fast_dropout(self.in_proj(x), cfg.dropout, generator), valid

    def forward(self, inputs, lengths=None, initial_state: Optional[RNNState] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, RNNState]:
        cfg = self.cfg
        B, T = inputs.shape[0], inputs.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64, device=inputs.device)
        if initial_state is not None and initial_state.h.shape[0]:
            return self._stream(inputs, lengths, initial_state, generator)
        if initial_state is not None:
            raise ValueError(
                "this Conformer is full-context (attention_chunk=0) and "
                "does not support streaming chunk carries; set "
                "transnet.attention_chunk > 0 (with bidirectional=false) "
                "for the chunked-causal streaming variant")
        x, valid = self._project_in(inputs, lengths, generator)
        cm = self._chunk_mask(x.shape[1], x.device)
        mask = valid[:, None, :] if cm is None else (cm & valid[:, None, :])
        remat = remat_active(cfg.remat, self, x)
        for blk in self.blocks:
            x = (_remat_block(blk, x, valid, mask, generator) if remat
                 else blk(x, valid, mask, generator))
        out = torch.where(valid[..., None], self.out_proj(x), 0.0)
        if cfg.attention_chunk > 0:
            state = self.zero_state(B, out.dtype, out.device)
        else:
            state = RNNState(torch.zeros((0, 1, B, 0), dtype=out.dtype,
                                         device=out.device), None)
        return out, state

    def _stream(self, inputs, lengths, state: RNNState, generator):
        cfg = self.cfg
        C = cfg.attention_chunk
        if C <= 0:
            raise ValueError("streaming requires attention_chunk > 0")
        S = cfg.output_frames(inputs.shape[1])
        if S != C:
            raise ValueError(
                f"streaming Conformer consumes exactly one attention chunk "
                f"per call: got {inputs.shape[1]} input frames -> {S} reduced, "
                f"expected attention_chunk={C} (feed chunk_frames="
                f"{C * cfg.time_reduction_stride})")
        x, valid = self._project_in(inputs, lengths, generator)
        hs, cs = [], []
        for i, blk in enumerate(self.blocks):
            # state layout: h (L, ctx, B, D+1), c (L, K-1, B, D)
            x, new_cache, new_tail = blk.stream(
                x, valid, state.h[i].transpose(0, 1), state.c[i].transpose(0, 1),
                generator)
            hs.append(new_cache.transpose(0, 1))
            cs.append(new_tail.transpose(0, 1))
        out = torch.where(valid[..., None], self.out_proj(x), 0.0)
        return out, RNNState(torch.stack(hs), torch.stack(cs))

    def zero_state(self, batch: int, dtype=torch.float32, device=None) -> RNNState:
        """Streaming cache zeros: every validity flag 0, so nothing is
        attended until real chunks fill the window."""
        cfg = self.cfg
        ctx = cfg.attention_left_chunks * cfg.attention_chunk
        h = torch.zeros((cfg.num_layers, ctx, batch, cfg.hidden_size + 1),
                        dtype=dtype, device=device)
        c = torch.zeros((cfg.num_layers, cfg.conv_kernel_size - 1, batch,
                         cfg.hidden_size), dtype=dtype, device=device)
        return RNNState(h, c)


def _map_tree(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_conformer_block_params(encoder_params: Dict, num_layers: int,
                                 group: int = 1) -> Dict:
    """A per-block encoder param subtree (``block_0`` .. ``block_{L-1}``,
    nested dicts of numpy arrays) in the ``scan_blocks=True`` layout: for
    ``group=1`` one ``blocks`` subtree with a leading L axis; for
    ``group=G`` a ``blocks`` subtree of ``g{j}`` members, each stacked over
    the L/G scan steps (global block s*G + j)."""
    out = {k: v for k, v in encoder_params.items() if not k.startswith("block_")}
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    if group <= 1:
        out["blocks"] = _map_tree(
            stack, *[encoder_params[f"block_{i}"] for i in range(num_layers)])
        return out
    if num_layers % group:
        raise ValueError(f"num_layers={num_layers} not divisible by "
                         f"scan_block_group={group}")
    steps = num_layers // group
    out["blocks"] = {
        f"g{j}": _map_tree(stack, *[encoder_params[f"block_{s * group + j}"]
                                    for s in range(steps)])
        for j in range(group)}
    return out


def unstack_conformer_block_params(encoder_params: Dict, num_layers: int,
                                   group: int = 1) -> Dict:
    """The inverse of :func:`stack_conformer_block_params`."""
    st = encoder_params["blocks"]
    out = {k: v for k, v in encoder_params.items() if k != "blocks"}
    if group <= 1:
        for i in range(num_layers):
            out[f"block_{i}"] = _map_tree(lambda x, i=i: x[i], st)
        return out
    for s in range(num_layers // group):
        for j in range(group):
            out[f"block_{s * group + j}"] = _map_tree(lambda x, s=s: x[s], st[f"g{j}"])
    return out
