"""Prediction network (port of ``rnntransducer_tpu/models/prednet.py``).

Embedding (the pad row embeds to zero) -> unidirectional RNN -> projection,
in a full-sequence mode and a single-step decode mode.  ``rnn_type=
"stateless"`` selects the stateless n-gram prediction network: the
concatenated embeddings of the last ``num_layers + 1`` labels through one
projection, with the context carried in the same ``RNNState`` layout
(``h[i]`` = embedding of the (i+1)-back label, shape (num_layers, 1, B, H)).
With a ``generator`` (training), the recurrent mode applies the stack's
inter-layer dropout and the stateless mode plain dropout on the context
features (flax ``nn.Dropout`` semantics: keep with 1 - rate, rescale).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rnntransducer_tpu_torch.config import PredNetConfig
from rnntransducer_tpu_torch.models.cells import RNNState, StackedRNN


class PredictionNet(nn.Module):
    def __init__(self, cfg: PredNetConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.embedding_size, cfg.hidden_size)
        self.stateless = cfg.rnn_type.lower() == "stateless"
        if self.stateless:
            proj_in = (cfg.num_layers + 1) * cfg.hidden_size
        else:
            self.rnn = StackedRNN(cfg.hidden_size, cfg.hidden_size, cfg.num_layers,
                                  cfg.rnn_type.lower(), bidirectional=False,
                                  dropout=cfg.dropout)
            proj_in = cfg.hidden_size
        self.out_proj = nn.Linear(proj_in, cfg.output_size)

    def _embed(self, tokens):
        emb = self.embedding(tokens)
        pad = (tokens != self.cfg.pad_token_id)[..., None]
        return torch.where(pad, emb, torch.zeros_like(emb))

    # ---- stateless (n-gram context) mode -------------------------------
    def _stateless_call(self, tokens, lengths, initial_state, generator):
        emb = self._embed(tokens)                          # (B, U1, H)
        B, U1, H = emb.shape
        nctx = self.cfg.num_layers
        if initial_state is None:
            pre = emb.new_zeros((B, nctx, H))
        else:
            pre = initial_state.h[:, 0].transpose(0, 1).flip(1).to(emb.dtype)
        ext = torch.cat([pre, emb], dim=1)                 # (B, nctx+U1, H)
        feats = torch.cat([ext[:, nctx - s:nctx - s + U1] for s in range(nctx + 1)],
                          dim=-1)
        rate = self.cfg.dropout
        if generator is not None and rate > 0.0:
            keep = torch.rand(feats.shape, device=feats.device,
                              generator=generator) < 1.0 - rate
            feats = torch.where(keep, feats / (1.0 - rate), torch.zeros_like(feats))
        out = self.out_proj(feats)
        ln = (torch.full((B,), U1, dtype=torch.int64, device=emb.device)
              if lengths is None else lengths.to(torch.int64))
        rows = torch.arange(B, device=emb.device)
        hs = [ext[rows, (nctx + ln - 1 - i).clamp(0, nctx + U1 - 1)]
              for i in range(nctx)]
        return out, RNNState(torch.stack(hs, 0)[:, None], None)

    def _stateless_step(self, token, state):
        emb = self._embed(token)                           # (B, H)
        B, H = emb.shape
        nctx = self.cfg.num_layers
        h = (emb.new_zeros((nctx, 1, B, H)) if state is None else state.h)
        parts = [emb] + [h[i, 0].to(emb.dtype) for i in range(nctx)]
        out = self.out_proj(torch.cat(parts, dim=-1))
        new = emb[None, None].to(h.dtype)
        new_h = torch.cat([new, h[:-1]], 0) if nctx > 1 else new
        return out, RNNState(new_h, None)

    # ---- public API (both modes) ---------------------------------------
    def forward(self, tokens, lengths=None, initial_state: Optional[RNNState] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, RNNState]:
        """tokens: (B, U+1) blank-prepended ids -> ((B, U+1, out), state).
        ``generator`` turns dropout on."""
        if self.stateless:
            return self._stateless_call(tokens, lengths, initial_state, generator)
        out, state = self.rnn(self._embed(tokens), lengths, initial_state, generator)
        return self.out_proj(out), state

    def step(self, token, state: Optional[RNNState]) -> Tuple[torch.Tensor, RNNState]:
        """token: (B,) ids -> ((B, out), new state)."""
        if self.stateless:
            return self._stateless_step(token, state)
        out, state = self.rnn.step(self._embed(token), state)
        return self.out_proj(out), state
