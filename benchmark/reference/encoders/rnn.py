"""The recurrent encoder: a stack of (bidirectional) GRU or LSTM layers over
the 80 log-mel features and a projection (the reference repository's
``networks/encoder.py``); the recurrent layers the prediction networks use.

Recurrent weights per layer and direction: ``w_ih`` (in, G*H), ``w_hh`` (H,
G*H), ``b_ih``, ``b_hh`` (G*H), gates in torch's order (LSTM i, f, g, o; GRU
r, z, n with ``b_hn`` inside ``r * (...)``).

The layers run through torch's own GRU / LSTM (cuDNN on the card) on packed
sequences, so a padded step neither moves the carry nor emits: the per-step
Python loop of the same equations launches about 400,000 kernels a pass at
2048 frames.  Training checkpoints every layer, so a full-size step fits on
one card.  Dropout (training) goes on the input of every layer after the
first, as the program's ``StackedRNN`` draws it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

from benchmark.reference.augment import dropout
from benchmark.reference.layers import Spec, lin, linear_specs, maybe_checkpoint
from benchmark.reference.precision import operand

GATES = {"gru": 3, "lstm": 4}
WEIGHTS = ("w_ih", "w_hh", "b_ih", "b_hh")


def rnn_specs(prefix: str, n_in: int, H: int, layers: int, kind: str, dirs) -> List[Spec]:
    out: List[Spec] = []
    g = GATES[kind]
    for d in dirs:
        for layer in range(layers):
            i = n_in if layer == 0 else len(dirs) * H
            p = f"{prefix}.{d}.{layer}"
            out.append((f"{p}.w_ih", (i, g * H), "uniform", H))
            out.append((f"{p}.w_hh", (H, g * H), "uniform", H))
            out.append((f"{p}.b_ih", (g * H,), "uniform", H))
            out.append((f"{p}.b_hh", (g * H,), "uniform", H))
    return out


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


def rnn_stack(P, prefix, kind, x, lengths, layers, bidirectional, precision,
              remat: bool, keeps: Sequence[torch.Tensor] = (), rate: float = 0.0):
    """``layers`` recurrent layers; the input of layer ``l`` >= 1 dropped at
    ``rate`` on ``keeps[l - 1]`` where the step drew masks."""
    dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
    for layer in range(layers):
        if layer > 0 and keeps:
            x = dropout(x, keeps[layer - 1], rate)
        w = [P[f"{prefix}.{d}.{layer}.{n}"] for d in dirs for n in WEIGHTS]

        def run(x, *w):
            return _rnn_layer(kind, x, lengths, list(w), bidirectional, precision)
        x = maybe_checkpoint(run, x, *w) if remat else run(x, *w)
    return x


def stack_dropout_sites(section) -> List[float]:
    """One mask at the section's rate on the input of each layer after the
    first."""
    rate = section.get("dropout", 0.0) if section["num_layers"] > 1 else 0.0
    return [rate] * (section["num_layers"] - 1) if rate > 0 else []


# ------------------------------------------------------------------ encoder
def _dirs(tn):
    return ("fwd", "bwd") if tn["bidirectional"] else ("fwd",)


def param_specs(tn) -> List[Spec]:
    dirs = _dirs(tn)
    return (rnn_specs("encoder.rnn", tn["input_size"], tn["hidden_size"], tn["num_layers"],
                      tn["rnn_type"], dirs)
            + linear_specs("encoder.out_proj", len(dirs) * tn["hidden_size"],
                           tn["output_size"]))


def takes_gain(name: str) -> bool:
    """The input-side products: ``w_ih`` and the projection."""
    return name.endswith(".w_ih") or name.endswith("proj.weight")


dropout_sites = stack_dropout_sites


def encode(P, tn, feats, lengths, precision, remat, keeps):
    x = rnn_stack(P, "encoder.rnn", tn["rnn_type"], feats, lengths, tn["num_layers"],
                  tn["bidirectional"], precision, remat, keeps, tn.get("dropout", 0.0))
    return lin(x, P, "encoder.out_proj", precision), lengths
