"""The chunked-causal Conformer encoder (Gulati et al. 2020): frame
stacking, an input projection, macaron blocks ``x += 1/2 FFN(LN x); x +=
MHSA(LN x); x += Conv(LN x); x += 1/2 FFN(LN x); x = LN(x)`` with rotary
positions and a GLU + causal depthwise conv module, an output projection.
The depthwise conv's weight is (K, 1, d), its bias (d).

Dropout (training) at the program's sites, in its call order: once after
the input projection, then seven times a block: the feed-forward's hidden
activation and output, the attention probabilities and output, the conv
module's output, the second feed-forward's hidden activation and output.
A mask may be longer in time than the reference's frames (the program pads
to its bucket): its first frames are the ones used.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference.augment import dropout
from benchmark.reference.layers import (NEG, Spec, layer_norm, length_mask, lin,
                                        linear_specs, maybe_checkpoint, norm_specs)
from benchmark.reference.precision import operand

SITES_PER_BLOCK = 7


def param_specs(tn) -> List[Spec]:
    d, stride = tn["hidden_size"], tn.get("time_reduction_stride", 1)
    ff, K = tn["ff_multiplier"], tn["conv_kernel_size"]
    out = linear_specs("encoder.in_proj", tn["input_size"] * stride, d)
    for b in range(tn["num_layers"]):
        p = f"encoder.blocks.{b}"
        for f in ("ff1", "ff2"):
            out += norm_specs(f"{p}.{f}.norm", d)
            out += linear_specs(f"{p}.{f}.dense0", d, ff * d)
            out += linear_specs(f"{p}.{f}.dense1", ff * d, d)
        out += norm_specs(f"{p}.attn.norm", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out"):
            out += linear_specs(f"{p}.attn.{proj}", d, d)
        out += norm_specs(f"{p}.conv.norm", d)
        out += linear_specs(f"{p}.conv.pre", d, 2 * d)
        out.append((f"{p}.conv.conv.weight", (K, 1, d), "uniform", K))
        out.append((f"{p}.conv.conv.bias", (d,), "uniform", K))
        out += norm_specs(f"{p}.conv.post_norm", d)
        out += linear_specs(f"{p}.conv.post", d, d)
        out += norm_specs(f"{p}.final_norm", d)
    return out + linear_specs("encoder.out_proj", d, tn["output_size"])


def takes_gain(name: str) -> bool:
    """Every product's weight but the depthwise conv's."""
    return name.endswith(("proj.weight", "dense0.weight", "dense1.weight", "pre.weight",
                          "post.weight", "out.weight"))


def dropout_sites(tn) -> List[float]:
    rate = tn.get("dropout", 0.0)
    return [rate] * (1 + SITES_PER_BLOCK * tn["num_layers"]) if rate > 0 else []


def _rope(x: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding over (B, H, T, hd): feature i of the
    first half pairs with feature i of the second, at angle t *
    10000^(-i/half)."""
    T, hd = x.shape[2], x.shape[3]
    half = hd // 2
    inv = 10000.0 ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    sin, cos = torch.sin(ang).float(), torch.cos(ang).float()
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([rot, x[..., 2 * half:]], -1)


def _block(x, valid, mask, P, p, heads, K, precision, drop):
    """One block; ``drop(x, time_dims)`` is the next dropout site (the
    identity without masks)."""
    def ffn(y, f):
        h = F.silu(lin(layer_norm(y, P, f"{p}.{f}.norm"), P, f"{p}.{f}.dense0", precision))
        return drop(lin(drop(h), P, f"{p}.{f}.dense1", precision))

    x = x + 0.5 * ffn(x, "ff1")
    # multi-head self-attention, pre-norm, rotary positions
    B, T, D = x.shape
    hd = D // heads
    a = layer_norm(x, P, f"{p}.attn.norm")

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)
    q = _rope(split(lin(a, P, f"{p}.attn.q_proj", precision)))
    k = _rope(split(lin(a, P, f"{p}.attn.k_proj", precision)))
    v = split(lin(a, P, f"{p}.attn.v_proj", precision))
    s = torch.matmul(operand(q, precision), operand(k, precision).transpose(-1, -2))
    s = torch.where(mask[:, None], s / math.sqrt(hd), torch.full_like(s, NEG))
    att = drop(torch.softmax(s, -1), (2, 3))
    o = torch.matmul(operand(att, precision), operand(v, precision))
    x = x + drop(lin(o.transpose(1, 2).reshape(B, T, D), P, f"{p}.attn.out", precision))
    # conv module: GLU, causal depthwise conv, swish
    keep = valid[..., None]
    c = torch.where(keep, layer_norm(x, P, f"{p}.conv.norm"), 0.0)
    g1, g2 = lin(c, P, f"{p}.conv.pre", precision).chunk(2, -1)
    c = torch.where(keep, g1 * torch.sigmoid(g2), 0.0)
    w = P[f"{p}.conv.conv.weight"][:, 0].t()[:, None, :]            # (d, 1, K)
    c = F.conv1d(F.pad(c.transpose(1, 2), (K - 1, 0)), w, P[f"{p}.conv.conv.bias"],
                 groups=D).transpose(1, 2)
    c = lin(F.silu(layer_norm(c, P, f"{p}.conv.post_norm")), P, f"{p}.conv.post",
            precision)
    x = x + drop(c)
    x = x + 0.5 * ffn(x, "ff2")
    return layer_norm(x, P, f"{p}.final_norm")


def chunk_mask(T: int, chunk: int, left: int, device) -> torch.Tensor:
    """(T, T) chunked-causal mask: query frame t sees its own ``chunk``-frame
    chunk and the ``left`` chunks before it."""
    ci = torch.arange(T, device=device) // chunk
    d = ci[:, None] - ci[None, :]
    return (d >= 0) & (d <= left)


def _sites(keeps, rate):
    """``drop(x, time_dims=(1,))`` for each site in turn: masks ``keeps``
    at ``rate``; without masks, the identity."""
    it = iter(keeps)

    def drop(x, time_dims=(1,)):
        return dropout(x, next(it), rate, time_dims) if keeps else x
    return drop


def encode(P, tn, feats, lengths, precision, remat, keeps):
    stride = tn.get("time_reduction_stride", 1)
    B, T, M = feats.shape
    x = torch.where(length_mask(lengths, T)[..., None], feats, 0.0)
    pad = (-T) % stride
    x = F.pad(x, (0, 0, 0, pad)).reshape(B, (T + pad) // stride, stride * M)
    red = -(-lengths // stride)
    Tr = x.shape[1]
    valid = length_mask(red, Tr)
    mask = valid[:, None, :]
    if tn.get("attention_chunk", 0) > 0:
        mask = mask & chunk_mask(Tr, tn["attention_chunk"],
                                 tn.get("attention_left_chunks", 4), x.device)[None]
    rate = tn.get("dropout", 0.0)
    x = _sites(keeps[:1], rate)(lin(x, P, "encoder.in_proj", precision))
    for b in range(tn["num_layers"]):
        block_keeps = keeps[1 + SITES_PER_BLOCK * b:1 + SITES_PER_BLOCK * (b + 1)]

        def run(x, b=b, block_keeps=block_keeps):
            return _block(x, valid, mask, P, f"encoder.blocks.{b}", tn["attention_heads"],
                          tn["conv_kernel_size"], precision, _sites(block_keeps, rate))
        x = maybe_checkpoint(run, x) if remat else run(x)
    out = lin(x, P, "encoder.out_proj", precision)
    return torch.where(valid[..., None], out, 0.0), red
