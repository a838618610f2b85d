"""The RNN-T models of the benchmark's configurations in plain PyTorch.

Weights come as one dict keyed by parameter name (the state dict the harness
gives both sides) in these layouts:

* recurrent layers: ``w_ih`` (in, G*H), ``w_hh`` (H, G*H), ``b_ih``,
  ``b_hh`` (G*H), gates in torch's order (LSTM i, f, g, o; GRU r, z, n with
  ``b_hn`` inside ``r * (...)``);
* linear layers: ``weight`` (out, in), ``bias`` (out);
* the depthwise conv: ``weight`` (K, 1, d), ``bias`` (d).

Model (Graves 2012; the reference repository's networks): an encoder over
80 log-mel features (a stack of bidirectional GRU layers and a projection,
or a chunked-causal Conformer of Gulati et al. 2020), a prediction network
(embedding with the pad row at zero, LSTM layers, projection), and the
concat joint ``fc(gelu_tanh([enc; dec]))``.

The recurrent layers run through torch's own GRU / LSTM (cuDNN on the card)
on packed sequences, so a padded step neither moves the carry nor emits:
the per-step Python loop of the same equations launches about 400,000
kernels a pass at 2048 frames.  Training checkpoints every encoder layer or
block and every lattice chunk, so a full-size step fits on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import linear, operand

NEG = -1e30
LN_EPS = 1e-6
GATES = {"gru": 3, "lstm": 4}


# --------------------------------------------------------------- parameters
def param_specs(model: Mapping) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every parameter of ``model`` (the
    ``model`` section of a configuration).  init: "uniform" (+-1/sqrt(fan_in)),
    "normal", "ones", "zeros"."""
    tn, pn, jn = model["transnet"], model["prednet"], model["jointnet"]
    out: List[Tuple[str, tuple, str, int]] = []

    def lin(name, n_in, n_out):
        out.append((f"{name}.weight", (n_out, n_in), "uniform", n_in))
        out.append((f"{name}.bias", (n_out,), "uniform", n_in))

    def norm(name, d):
        out.append((f"{name}.weight", (d,), "ones", d))
        out.append((f"{name}.bias", (d,), "zeros", d))

    def rnn(prefix, n_in, H, layers, kind, dirs):
        g = GATES[kind]
        for d in dirs:
            for layer in range(layers):
                i = n_in if layer == 0 else len(dirs) * H
                p = f"{prefix}.{d}.{layer}"
                out.append((f"{p}.w_ih", (i, g * H), "uniform", H))
                out.append((f"{p}.w_hh", (H, g * H), "uniform", H))
                out.append((f"{p}.b_ih", (g * H,), "uniform", H))
                out.append((f"{p}.b_hh", (g * H,), "uniform", H))

    if tn.get("arch", "rnn") == "conformer":
        d, stride = tn["hidden_size"], tn.get("time_reduction_stride", 1)
        ff, K = tn["ff_multiplier"], tn["conv_kernel_size"]
        lin("encoder.in_proj", tn["input_size"] * stride, d)
        for b in range(tn["num_layers"]):
            p = f"encoder.blocks.{b}"
            for f in ("ff1", "ff2"):
                norm(f"{p}.{f}.norm", d)
                lin(f"{p}.{f}.dense0", d, ff * d)
                lin(f"{p}.{f}.dense1", ff * d, d)
            norm(f"{p}.attn.norm", d)
            for proj in ("q_proj", "k_proj", "v_proj", "out"):
                lin(f"{p}.attn.{proj}", d, d)
            norm(f"{p}.conv.norm", d)
            lin(f"{p}.conv.pre", d, 2 * d)
            out.append((f"{p}.conv.conv.weight", (K, 1, d), "uniform", K))
            out.append((f"{p}.conv.conv.bias", (d,), "uniform", K))
            norm(f"{p}.conv.post_norm", d)
            lin(f"{p}.conv.post", d, d)
            norm(f"{p}.final_norm", d)
        lin("encoder.out_proj", d, tn["output_size"])
    else:
        dirs = ("fwd", "bwd") if tn["bidirectional"] else ("fwd",)
        rnn("encoder.rnn", tn["input_size"], tn["hidden_size"], tn["num_layers"],
            tn["rnn_type"], dirs)
        lin("encoder.out_proj", len(dirs) * tn["hidden_size"], tn["output_size"])
    out.append(("prednet.embedding.weight", (pn["embedding_size"], pn["hidden_size"]),
                "normal", 1))
    rnn("prednet.rnn", pn["hidden_size"], pn["hidden_size"], pn["num_layers"],
        pn["rnn_type"], ("fwd",))
    lin("prednet.out_proj", pn["hidden_size"], pn["output_size"])
    lin("joint.fc", tn["output_size"] + pn["output_size"], jn["num_classes"])
    return out


# ----------------------------------------------------------------- helpers
def _mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _rnn_layer(kind: str, x, lengths, weights: List[torch.Tensor], bidirectional: bool,
               precision: str):
    """One (bi)directional layer over packed rows: x (B, T, in) -> (B, T,
    dirs*H), zero past each row's length.  ``weights`` per direction: w_ih,
    w_hh, b_ih, b_hh in this module's layout."""
    B, T = x.shape[0], x.shape[1]
    flat = []
    for i in range(0, len(weights), 4):
        w_ih, w_hh, b_ih, b_hh = weights[i:i + 4]
        flat += [operand(w_ih, precision).t().contiguous(),
                 operand(w_hh, precision).t().contiguous(), b_ih, b_hh]
    H = weights[1].shape[0]
    dirs = 2 if bidirectional else 1
    packed = pack_padded_sequence(operand(x, precision), lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)
    h0 = x.new_zeros((dirs, B, H))
    if kind == "gru":
        data, _ = torch._VF.gru(packed.data, packed.batch_sizes, h0, flat, True, 1,
                                0.0, torch.is_grad_enabled(), bidirectional)
    else:
        data, _, _ = torch._VF.lstm(packed.data, packed.batch_sizes, (h0, h0), flat,
                                    True, 1, 0.0, torch.is_grad_enabled(),
                                    bidirectional)
    out, _ = pad_packed_sequence(PackedSequence(data, packed.batch_sizes,
                                                packed.sorted_indices,
                                                packed.unsorted_indices),
                                 batch_first=True, total_length=T)
    return out


def _rnn_stack(P, prefix, kind, x, lengths, layers, bidirectional, precision,
               remat: bool, between=None):
    """``layers`` recurrent layers; ``between(layer, x)`` (dropout in
    training) on the input of each layer after the first."""
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
    for layer in range(layers):
        if layer > 0 and between is not None:
            x = between(layer, x)
        w = [P[f"{prefix}.{d}.{layer}.{n}"] for d in dirs for n in names]

        def run(x, *w):
            return _rnn_layer(kind, x, lengths, list(w), bidirectional, precision)
        x = _maybe_checkpoint(run, x, *w) if remat else run(x, *w)
    return x


def _layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"],
                        LN_EPS)


def _lin(x, P, name, precision):
    return linear(x, P[f"{name}.weight"], P[f"{name}.bias"], precision)


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


def _conformer_block(x, valid, mask, P, p, heads, K, precision):
    def ffn(y, f):
        h = F.silu(_lin(_layer_norm(y, P, f"{p}.{f}.norm"), P, f"{p}.{f}.dense0",
                        precision))
        return _lin(h, P, f"{p}.{f}.dense1", precision)

    x = x + 0.5 * ffn(x, "ff1")
    # multi-head self-attention, pre-norm, rotary positions
    B, T, D = x.shape
    hd = D // heads
    a = _layer_norm(x, P, f"{p}.attn.norm")

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)
    q = _rope(split(_lin(a, P, f"{p}.attn.q_proj", precision)))
    k = _rope(split(_lin(a, P, f"{p}.attn.k_proj", precision)))
    v = split(_lin(a, P, f"{p}.attn.v_proj", precision))
    s = torch.matmul(operand(q, precision), operand(k, precision).transpose(-1, -2))
    s = torch.where(mask[:, None], s / math.sqrt(hd), torch.full_like(s, NEG))
    o = torch.matmul(operand(torch.softmax(s, -1), precision), operand(v, precision))
    x = x + _lin(o.transpose(1, 2).reshape(B, T, D), P, f"{p}.attn.out", precision)
    # conv module: GLU, causal depthwise conv, swish
    keep = valid[..., None]
    c = torch.where(keep, _layer_norm(x, P, f"{p}.conv.norm"), 0.0)
    g1, g2 = _lin(c, P, f"{p}.conv.pre", precision).chunk(2, -1)
    c = torch.where(keep, g1 * torch.sigmoid(g2), 0.0)
    w = P[f"{p}.conv.conv.weight"][:, 0].t()[:, None, :]            # (d, 1, K)
    c = F.conv1d(F.pad(c.transpose(1, 2), (K - 1, 0)), w, P[f"{p}.conv.conv.bias"],
                 groups=D).transpose(1, 2)
    c = _lin(F.silu(_layer_norm(c, P, f"{p}.conv.post_norm")), P, f"{p}.conv.post",
             precision)
    x = x + c
    x = x + 0.5 * ffn(x, "ff2")
    return _layer_norm(x, P, f"{p}.final_norm")


def chunk_mask(T: int, chunk: int, left: int, device) -> torch.Tensor:
    """(T, T) chunked-causal mask: query frame t sees its own ``chunk``-frame
    chunk and the ``left`` chunks before it."""
    ci = torch.arange(T, device=device) // chunk
    d = ci[:, None] - ci[None, :]
    return (d >= 0) & (d <= left)


def _conformer(P, tn, feats, lengths, precision, remat):
    stride = tn.get("time_reduction_stride", 1)
    B, T, M = feats.shape
    x = torch.where(_mask(lengths, T)[..., None], feats, 0.0)
    pad = (-T) % stride
    x = F.pad(x, (0, 0, 0, pad)).reshape(B, (T + pad) // stride, stride * M)
    red = -(-lengths // stride)
    Tr = x.shape[1]
    valid = _mask(red, Tr)
    mask = valid[:, None, :]
    if tn.get("attention_chunk", 0) > 0:
        mask = mask & chunk_mask(Tr, tn["attention_chunk"],
                                 tn.get("attention_left_chunks", 4), x.device)[None]
    x = _lin(x, P, "encoder.in_proj", precision)
    for b in range(tn["num_layers"]):
        def run(x, b=b):
            return _conformer_block(x, valid, mask, P, f"encoder.blocks.{b}",
                                    tn["attention_heads"], tn["conv_kernel_size"],
                                    precision)
        x = _maybe_checkpoint(run, x) if remat else run(x)
    out = _lin(x, P, "encoder.out_proj", precision)
    return torch.where(valid[..., None], out, 0.0), red


# ------------------------------------------------------------------ model
class Reference:
    """The model of ``model_cfg`` over the weights ``P``, in ``precision``
    ("fp32" or the "fp8" control).  ``remat`` checkpoints the encoder's
    layers or blocks (training at full size)."""

    def __init__(self, model_cfg: Mapping, P: Mapping[str, torch.Tensor],
                 precision: str = "fp32", remat: bool = False):
        self.cfg = model_cfg
        self.P = P
        self.precision = precision
        self.remat = remat
        self.blank = model_cfg["prednet"].get("pad_token_id", 0)

    # encoder: (B, T, 80) features and frame lengths -> (B, T', De), lengths;
    # ``between(layer, x)`` (training's dropout) between recurrent layers
    def encode(self, feats, lengths, between=None) -> Tuple[torch.Tensor, torch.Tensor]:
        tn = self.cfg["transnet"]
        lengths = lengths.to(torch.int64)
        if tn.get("arch", "rnn") == "conformer":
            return _conformer(self.P, tn, feats, lengths, self.precision, self.remat)
        x = _rnn_stack(self.P, "encoder.rnn", tn["rnn_type"], feats, lengths,
                       tn["num_layers"], tn["bidirectional"], self.precision, self.remat,
                       between)
        return _lin(x, self.P, "encoder.out_proj", self.precision), lengths

    def _embed(self, tokens):
        emb = self.P["prednet.embedding.weight"][tokens]
        return torch.where((tokens != self.blank)[..., None], emb, 0.0)

    # prediction network over blank-prepended labels (B, U+1)
    def predict(self, text_in, text_lengths, between=None) -> torch.Tensor:
        pn = self.cfg["prednet"]
        x = _rnn_stack(self.P, "prednet.rnn", pn["rnn_type"], self._embed(text_in),
                       text_lengths.to(torch.int64), pn["num_layers"], False,
                       self.precision, False, between)
        return _lin(x, self.P, "prednet.out_proj", self.precision)

    def predict_step(self, token, state):
        """One label (N,) through the prediction network from ``state`` (a
        list of (h, c) per layer, or None): (dec (N, Dd), new state)."""
        pn = self.cfg["prednet"]
        x = self._embed(token)
        N, H = x.shape[0], pn["hidden_size"]
        new = []
        for layer in range(pn["num_layers"]):
            p = f"prednet.rnn.fwd.{layer}"
            h, c = state[layer] if state is not None else (x.new_zeros(N, H),) * 2
            gates = (linear(x, self.P[f"{p}.w_ih"].t(), self.P[f"{p}.b_ih"], self.precision)
                     + linear(h, self.P[f"{p}.w_hh"].t(), self.P[f"{p}.b_hh"],
                              self.precision))
            if pn["rnn_type"] == "lstm":
                i, f, g, o = gates.chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                raise ValueError("the reference decodes LSTM prediction networks")
            new.append((h, c))
            x = h
        return _lin(x, self.P, "prednet.out_proj", self.precision), new

    # joint: logits[t, u] = A[t] + C[u]
    def factors(self, enc, dec):
        w = self.P["joint.fc.weight"]
        De = enc.shape[-1]
        ge = F.gelu(enc, approximate="tanh")
        gd = F.gelu(dec, approximate="tanh")
        return (linear(ge, w[:, :De], None, self.precision),
                linear(gd, w[:, De:], self.P["joint.fc.bias"], self.precision))

    def enc_factor(self, enc):
        return self.factors(enc, enc.new_zeros(enc.shape[:-1] + (
            self.P["joint.fc.weight"].shape[1] - enc.shape[-1],)))[0]

    def dec_factor(self, dec):
        De = self.P["joint.fc.weight"].shape[1] - dec.shape[-1]
        return self.factors(dec.new_zeros(dec.shape[:-1] + (De,)), dec)[1]


def seeded_params(specs, generator: torch.Generator, device, blank_bias: float = 0.0,
                  suppressed: Optional[List[int]] = None, suppress_bias: float = 0.0,
                  blank: int = 0, encoder_gain: float = 1.0,
                  joint_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Weights of ``specs`` from ``generator`` in two large draws (one
    uniform, one normal) on ``device``, float32: uniform leaves in
    +-1/sqrt(fan_in), normal leaves N(0, 1), norms at 1 and 0.  The encoder's
    input-side products (``w_ih`` and linear weights) are scaled by
    ``encoder_gain`` and the joint's weights by ``joint_scale``; the joint's
    bias then gets ``blank_bias`` at the blank and ``suppress_bias`` at the
    ``suppressed`` ids.  Together they stand for a trained model: encoder
    features that move from frame to frame and a greedy decode that emits
    about as often as speech has graphemes."""
    n_uni = sum(int(np.prod(s)) for _, s, k, _ in specs if k == "uniform")
    n_nrm = sum(int(np.prod(s)) for _, s, k, _ in specs if k == "normal")
    uni = torch.rand(n_uni, generator=generator, device=device) * 2.0 - 1.0
    nrm = torch.randn(max(n_nrm, 1), generator=generator, device=device)
    out: Dict[str, torch.Tensor] = {}
    iu = inn = 0
    for name, shape, kind, fan_in in specs:
        n = int(np.prod(shape))
        if kind == "uniform":
            out[name] = (uni[iu:iu + n] / math.sqrt(fan_in)).reshape(shape)
            iu += n
        elif kind == "normal":
            out[name] = nrm[inn:inn + n].reshape(shape).clone()
            inn += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    for name, _, kind, _ in specs:
        if (name.startswith("encoder.") and kind == "uniform"
                and (name.endswith(".w_ih") or name.endswith("proj.weight")
                     or name.endswith("dense0.weight") or name.endswith("dense1.weight")
                     or name.endswith("pre.weight") or name.endswith("post.weight")
                     or name.endswith("out.weight"))):
            out[name] *= encoder_gain
    out["joint.fc.weight"] *= joint_scale
    bias = out["joint.fc.bias"]
    bias[blank] += blank_bias
    for i in suppressed or []:
        bias[i] += suppress_bias
    return out
