"""Masked recurrent cells (port of ``rnntransducer_tpu/models/cells.py``).

* The input projection ``x @ W_ih + b_ih`` for all timesteps is one matmul
  hoisted out of the time loop; the loop only does the recurrent product
  and the gates.
* A padded step (t >= length) keeps the carry and emits zeros
  (pack_padded semantics); the carry after the walk is the state at
  t = length-1.
* Bidirectional = a forward walk plus a reversed walk (``reverse=True``),
  which for length masks equals flip -> scan -> flip.
* Gate order and equations are torch's (i,f,g,o / r,z,n) with separate
  b_ih and b_hh; GRU's b_hn sits inside r * (...).
* Weights keep the JAX layout: ``w_ih`` (in, G*H) and ``w_hh`` (H, G*H).

GRU and LSTM layers run through ``ops.rnn_kernels.gru_scan`` /
``lstm_scan`` (the CUDA kernels on the card, their plain versions on the
CPU); when autograd records, through ``GRUScanFunction`` /
``LSTMScanFunction``, whose backward is the backward kernel.  A
bidirectional GRU layer whose input lies on a card where the paired
backward fits (``rnn_kernels.gru_pair_applies``) runs both directions
through ``GRUPairScanFunction`` when autograd records: the same forward
scans, and one paired backward launch for both.  Both keep an
fp32 carry, as the JAX package's Pallas kernels do (its XLA scan carries
the activation dtype).  Vanilla RNN layers, which have no kernel in the JAX
package either, use a plain masked loop in the activation dtype that
autograd differentiates.  ``step()`` (the decode path) is the plain single
step for every cell type.

Dropout (training only) follows the JAX package's ``FastDropout``: the rate
is quantized to n/256, uint8 bits come from an explicit
``torch.Generator``, kept values are rescaled by the quantized keep
probability.  It is active exactly when a generator is passed; the masks
differ from the JAX package's (another generator), their statistics do not.

``StackedRNN(remat=True)`` recomputes each layer in the backward pass
(``remat_call``, the JAX package's ``nn.remat(RNNLayer)``): only a layer's
input is kept, and the backward runs the layer's forward kernel again.  The
inter-layer dropout sits outside the recomputed layer, so nothing random is
replayed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rnntransducer_tpu_torch.ops import rnn_kernels
from rnntransducer_tpu_torch.ops.rnn_kernels import (GRUPairScanFunction,
                                                    GRUScanFunction,
                                                    LSTMScanFunction, gru_scan,
                                                    lstm_scan)
from rnntransducer_tpu_torch.utils.masking import length_mask

GATES = {"lstm": 4, "gru": 3, "rnn": 1}


class RNNState(NamedTuple):
    """Stacked recurrent state: h (and c for LSTM) of shape
    (num_layers, num_directions, B, H).  ``c`` is None for GRU/RNN."""

    h: torch.Tensor
    c: Optional[torch.Tensor] = None


def drop_thresh(rate: float) -> int:
    """Drop rate quantized to n/256 (the uint8 mask granularity)."""
    return int(round(rate * 256))


def fast_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``FastDropout`` (``cells.py:61-124`` of the JAX package): identity
    without a generator or at a rate below 1/512; else zero each element
    whose uint8 draw is below round(rate * 256) and rescale the rest by
    1 / (1 - thresh / 256), so E[output] == x."""
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    thresh = drop_thresh(rate)
    if thresh == 0:
        return x
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    keep_scale = 1.0 / (1.0 - thresh / 256.0)
    return torch.where(bits >= thresh, x * keep_scale, torch.zeros_like(x))


def _lstm_step(c, xw, hw):
    i, f, g, o = torch.chunk(xw + hw, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(h, xw, hw):
    xr, xz, xn = torch.chunk(xw, 3, dim=-1)
    hr, hz, hn = torch.chunk(hw, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _plain_cell(rnn_type, w_hh, b_hh, h, c, xw_t, mask_t):
    """Plain masked step: (h, c, output) from the carry and xw_t (B, G*H);
    mask_t (B, 1)."""
    hw = torch.matmul(h, w_hh) + b_hh
    if rnn_type == "lstm":
        h_new, c_new = _lstm_step(c, xw_t, hw)
        c = torch.where(mask_t, c_new, c)
    elif rnn_type == "gru":
        h_new = _gru_step(h, xw_t, hw)
    else:
        h_new = torch.tanh(xw_t + hw)
    h = torch.where(mask_t, h_new, h)
    return h, c, torch.where(mask_t, h_new, torch.zeros_like(h_new))


def layer_scan(rnn_type: str, xw_t, w_hh, b_hh, h, c, lengths_t, reverse: bool = False):
    """One direction of one layer over time-major pre-activations xw_t
    (T, B, G*H) from the carry (h, c) (c is passed through for GRU / RNN);
    lengths_t (B,) within [0, T].  Returns (outputs (T, B, H), h, c), the
    carry in the dtypes it came in.  GRU and LSTM run on their kernels
    (through the autograd functions when autograd records); the vanilla RNN
    on a plain loop."""
    T = xw_t.shape[0]
    if rnn_type == "gru":
        args = (xw_t, w_hh, b_hh, h.to(xw_t.dtype), lengths_t, reverse)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args[:4]):
            outs, h_fin = GRUScanFunction.apply(*args)
        else:
            outs, h_fin = gru_scan(*args)
        return outs, h_fin.to(h.dtype), c
    if rnn_type == "lstm":
        args = (xw_t, w_hh, b_hh, h.to(xw_t.dtype), c.to(xw_t.dtype), lengths_t, reverse)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args[:5]):
            outs, h_fin, c_fin = LSTMScanFunction.apply(*args)
        else:
            outs, h_fin, c_fin = lstm_scan(*args)
        return outs, h_fin.to(h.dtype), c_fin.to(c.dtype)
    mask_t = length_mask(lengths_t, T).transpose(0, 1)[..., None]  # (T, B, 1)
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c, outs[t] = _plain_cell(rnn_type, w_hh, b_hh, h, c, xw_t[t], mask_t[t])
    return (torch.stack(outs) if T else xw_t.new_zeros((0,) + h.shape)), h, c


class RNNLayer(nn.Module):
    """One direction of one recurrent layer."""

    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "lstm",
                 reverse: bool = False):
        super().__init__()
        g = GATES[rnn_type]
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.w_ih = nn.Parameter(torch.empty(input_size, g * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, g * hidden_size))
        self.b_ih = nn.Parameter(torch.empty(g * hidden_size))
        self.b_hh = nn.Parameter(torch.empty(g * hidden_size))

    def _cell(self, h, c, xw_t, mask_t):
        """Plain step. xw_t: (B, G*H) input pre-activation; mask_t: (B, 1)."""
        return _plain_cell(self.rnn_type, self.w_hh, self.b_hh, h, c, xw_t, mask_t)

    def init_state(self, batch: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
        return z, z

    def project(self, x):
        """The input pre-activations of every step, time major: x (B, T, in)
        -> (T, B, G*H)."""
        return (torch.matmul(x, self.w_ih) + self.b_ih).transpose(0, 1).contiguous()

    def forward(self, x, lengths, initial_state=None):
        """x: (B, T, input_size); lengths: (B,) int.
        Returns (outputs (B, T, H), final (h, c))."""
        B, T = x.shape[0], x.shape[1]
        if initial_state is None:
            initial_state = self.init_state(B, x.dtype, x.device)
        h, c = initial_state
        xw_t = self.project(x)
        outs, h, c = layer_scan(self.rnn_type, xw_t, self.w_hh, self.b_hh, h, c,
                                lengths.clamp(0, T), self.reverse)
        return outs.transpose(0, 1), (h, c)

    def step(self, x_t, state):
        """Single timestep (decode path). x_t: (B, input_size)."""
        h, c = state
        xw = torch.matmul(x_t, self.w_ih) + self.b_ih
        ones = torch.ones((x_t.shape[0], 1), dtype=torch.bool, device=x_t.device)
        h, c, out = self._cell(h, c, xw, ones)
        return out, (h, c)


class GRUPair(nn.Module):
    """Both directions of one bidirectional GRU layer, run together through
    ``GRUPairScanFunction``: their input projections, then their scans, whose
    backward is one paired kernel launch.  Built around a ``StackedRNN``'s
    own two layers for one call; its outputs equal theirs run one by one."""

    def __init__(self, fwd: RNNLayer, bwd: RNNLayer):
        super().__init__()
        self.fwd, self.bwd = fwd, bwd

    def forward(self, x, lengths, f_state, b_state):
        """x: (B, T, input_size); lengths: (B,); f_state / b_state: each
        direction's (h, c).  Returns ((outputs, (h, c)) of the forward
        direction, the same of the reversed one), as ``RNNLayer`` returns."""
        (hf, cf), (hb, cb) = f_state, b_state
        xw_f, xw_b = self.fwd.project(x), self.bwd.project(x)
        f_all, f_fin, b_all, b_fin = GRUPairScanFunction.apply(
            xw_f, self.fwd.w_hh, self.fwd.b_hh, hf.to(xw_f.dtype),
            xw_b, self.bwd.w_hh, self.bwd.b_hh, hb.to(xw_b.dtype),
            lengths.clamp(0, x.shape[1]))
        return ((f_all.transpose(0, 1), (f_fin.to(hf.dtype), cf)),
                (b_all.transpose(0, 1), (b_fin.to(hb.dtype), cb)))


def remat_call(module: nn.Module, *args):
    """``module(*args)`` recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) on the params the forward
    saw: under ``functional_call`` those are the swapped-in tensors (the
    bf16 cast copies of a train step), not the module's own."""
    params = dict(module.named_parameters())
    return checkpoint(lambda *a: torch.func.functional_call(module, params, a),
                      *args, use_reentrant=False)


def remat_active(on: bool, module: nn.Module, x: torch.Tensor) -> bool:
    """Whether a ``remat`` setting takes effect on this call: grads are
    recorded and the input or a param of ``module`` requires them."""
    return on and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


class StackedRNN(nn.Module):
    """Multi-layer (optionally bidirectional) RNN, batch first.  Layer l of
    direction d is ``fwd[l]`` / ``bwd[l]``.  Inter-layer dropout goes on the
    input of layers 1..L-1 (torch's dropout on every layer's output but the
    last), never on the last layer's output.  ``remat``: each layer is
    recomputed in the backward pass (:func:`remat_call`); a layer whose
    directions run as a :class:`GRUPair` is recomputed as one unit."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 rnn_type: str = "lstm", bidirectional: bool = False,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout = dropout
        self.remat = remat
        self.num_layers = num_layers
        self.rnn_type = rnn_type
        self.bidirectional = bidirectional
        width = (2 if bidirectional else 1) * hidden_size
        sizes = [input_size] + [width] * (num_layers - 1)
        self.fwd = nn.ModuleList(RNNLayer(s, hidden_size, rnn_type) for s in sizes)
        self.bwd = nn.ModuleList(
            RNNLayer(s, hidden_size, rnn_type, reverse=True) for s in sizes
        ) if bidirectional else nn.ModuleList()

    @property
    def output_size(self) -> int:
        return (2 if self.bidirectional else 1) * self.hidden_size

    def _pack_state(self, finals) -> RNNState:
        """finals: per layer, a tuple of per-direction (h, c)."""
        h = torch.stack([torch.stack([d[0] for d in f]) for f in finals])
        if self.rnn_type == "lstm":
            c = torch.stack([torch.stack([d[1] for d in f]) for f in finals])
            return RNNState(h, c)
        return RNNState(h, None)

    def _layer_state(self, state: Optional[RNNState], layer: int, direction: int,
                     batch: int, dtype, device):
        if state is None:
            z = torch.zeros((batch, self.hidden_size), dtype=dtype, device=device)
            return z, z
        h = state.h[layer, direction]
        c = state.c[layer, direction] if state.c is not None else torch.zeros_like(h)
        return h, c

    def forward(self, x, lengths=None, initial_state: Optional[RNNState] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, T, F); lengths: (B,) or None (= all T); ``generator``
        turns inter-layer dropout on (training).
        Returns (outputs (B, T, D*H), RNNState)."""
        B, T = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
        call = remat_call if remat_active(self.remat, self, x) else nn.Module.__call__
        out = x
        finals = []
        for layer in range(self.num_layers):
            if layer > 0:
                out = fast_dropout(out, self.dropout, generator)
            f_state = self._layer_state(initial_state, layer, 0, B, x.dtype, x.device)
            if self._paired(layer, out):
                (f_out, f_fin), (b_out, b_fin) = call(
                    GRUPair(self.fwd[layer], self.bwd[layer]), out, lengths, f_state,
                    self._layer_state(initial_state, layer, 1, B, x.dtype, x.device))
                out = torch.cat([f_out, b_out], dim=-1)
                finals.append((f_fin, b_fin))
                continue
            f_out, f_fin = call(self.fwd[layer], out, lengths, f_state)
            if self.bidirectional:
                b_out, b_fin = call(
                    self.bwd[layer], out, lengths,
                    self._layer_state(initial_state, layer, 1, B, x.dtype, x.device))
                out = torch.cat([f_out, b_out], dim=-1)
                finals.append((f_fin, b_fin))
            else:
                out = f_out
                finals.append((f_fin,))
        return out, self._pack_state(finals)

    def _paired(self, layer: int, x) -> bool:
        """Whether layer ``layer`` runs its two directions as a
        :class:`GRUPair`: a bidirectional GRU whose grads autograd records,
        on the route ``rnn_kernels.gru_pair_applies`` sees from the input
        (a card where the paired backward fits, no tracer)."""
        if not (self.bidirectional and self.rnn_type == "gru" and torch.is_grad_enabled()):
            return False
        layers = (self.fwd[layer], self.bwd[layer])
        if not (x.requires_grad or any(p.requires_grad for l in layers
                                       for p in l.parameters())):
            return False
        return rnn_kernels.gru_pair_applies(x, self.hidden_size)

    def step(self, x_t, state: Optional[RNNState]):
        """Single-step stateful mode (unidirectional only). x_t: (B, in)."""
        if self.bidirectional:
            raise ValueError("step() requires a unidirectional RNN")
        B = x_t.shape[0]
        out = x_t
        finals = []
        for layer in range(self.num_layers):
            s = self._layer_state(state, layer, 0, B, x_t.dtype, x_t.device)
            out, fin = self.fwd[layer].step(out, s)
            finals.append((fin,))
        return out, self._pack_state(finals)
