"""The recurrent prediction network (the reference repository's
``networks/decoder.py``): an embedding with the pad row at zero, a stack of
LSTM layers (GRU: ``prednets/gru.py``), a projection.  Dropout (training) on
the input of every layer after the first."""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.encoders.rnn import rnn_specs, rnn_stack, stack_dropout_sites
from benchmark.reference.layers import Spec, lin, linear_specs
from benchmark.reference.precision import linear

dropout_sites = stack_dropout_sites


def param_specs(pn) -> List[Spec]:
    return ([("prednet.embedding.weight", (pn["embedding_size"], pn["hidden_size"]),
              "normal", 1)]
            + rnn_specs("prednet.rnn", pn["hidden_size"], pn["hidden_size"],
                        pn["num_layers"], pn["rnn_type"], ("fwd",))
            + linear_specs("prednet.out_proj", pn["hidden_size"], pn["output_size"]))


def embed(P, tokens, blank):
    emb = P["prednet.embedding.weight"][tokens]
    return torch.where((tokens != blank)[..., None], emb, 0.0)


def predict(P, pn, text_in, text_lengths, precision, keeps, blank):
    """Over blank-prepended labels (B, U+1) -> (B, U+1, Dd)."""
    x = rnn_stack(P, "prednet.rnn", pn["rnn_type"], embed(P, text_in, blank),
                  text_lengths.to(torch.int64), pn["num_layers"], False, precision, False,
                  keeps, pn.get("dropout", 0.0))
    return lin(x, P, "prednet.out_proj", precision)


def predict_step(P, pn, token, state, precision, blank):
    """One label (N,) from ``state`` (a list of (h, c) per layer, or None):
    (output (N, Dd), new state)."""
    x = embed(P, token, blank)
    N, H = x.shape[0], pn["hidden_size"]
    new = []
    for layer in range(pn["num_layers"]):
        p = f"prednet.rnn.fwd.{layer}"
        h, c = state[layer] if state is not None else (x.new_zeros(N, H),) * 2
        gates = (linear(x, P[f"{p}.w_ih"].t(), P[f"{p}.b_ih"], precision)
                 + linear(h, P[f"{p}.w_hh"].t(), P[f"{p}.b_hh"], precision))
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        new.append((h, c))
        x = h
    return lin(x, P, "prednet.out_proj", precision), new
