"""Joint network (port of ``rnntransducer_tpu/models/joint.py``).

``combine="concat"``: fc(gelu_tanh(concat(enc, dec))), computed over a
(T, U) lattice through its rank factors; ``combine="add"``: per-side
projections to ``hidden_size``, GELU of the sum, then fc.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rnntransducer_tpu_torch.config import JointNetConfig


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _broadcast(enc, dec):
    if enc.dim() == dec.dim() and enc.dim() >= 3:
        T, U = enc.shape[-2], dec.shape[-2]
        enc = enc[..., :, None, :].expand(*enc.shape[:-2], T, U, enc.shape[-1])
        dec = dec[..., None, :, :].expand(*dec.shape[:-2], T, U, dec.shape[-1])
    return enc, dec


class JointNetwork(nn.Module):
    def __init__(self, cfg: JointNetConfig, enc_size: int, dec_size: int):
        super().__init__()
        self.cfg = cfg
        if cfg.combine == "add":
            self.enc_proj = nn.Linear(enc_size, cfg.hidden_size)
            self.dec_proj = nn.Linear(dec_size, cfg.hidden_size)
            self.fc = nn.Linear(cfg.hidden_size, cfg.num_classes)
        elif cfg.combine == "concat":
            self.fc = nn.Linear(enc_size + dec_size, cfg.num_classes)
        else:
            raise ValueError(f"unknown combine: {cfg.combine}")

    def keep_vocab_rows(self, start: int, size: int) -> None:
        """Keep only the fc's V rows [start, start + size) (this rank's share
        of a vocab-sharded classifier): its params are that slice."""
        fc = self.fc
        fc.weight = nn.Parameter(fc.weight.detach()[start:start + size].clone(),
                                 requires_grad=fc.weight.requires_grad)
        fc.bias = nn.Parameter(fc.bias.detach()[start:start + size].clone(),
                               requires_grad=fc.bias.requires_grad)
        fc.out_features = size

    def factors(self, enc, dec, shard=None):
        """(A, C) with logits[..., t, u, :] == A[..., t, :] + C[..., u, :]
        (the fc bias is folded into C).  concat-combine only.  Under a
        ``parallel.mesh.VocabShard`` the fc holds this rank's V rows and
        (A, C) are this rank's columns; ``enc`` and ``dec`` enter through a
        region whose backward sums their cotangents over the model group,
        so their grads are the single device's."""
        if self.cfg.combine != "concat":
            raise ValueError("factors requires combine='concat'; "
                             f"got {self.cfg.combine!r}")
        if shard is not None:
            from rnntransducer_tpu_torch.parallel.mesh import copy_to
            enc, dec = copy_to(enc, shard.mesh), copy_to(dec, shard.mesh)
        ge, gd = _gelu(enc), _gelu(dec)
        De = ge.shape[-1]
        w = self.fc.weight                                  # (V, De + Dd)
        return ge @ w[:, :De].t(), gd @ w[:, De:].t() + self.fc.bias

    def forward(self, enc, dec):
        """enc: (..., T, De) or (..., De); dec: (..., U, Dd) or (..., Dd).
        When both carry a sequence axis, broadcasts over (T, U)."""
        if self.cfg.combine == "add":
            enc, dec = _broadcast(self.enc_proj(enc), self.dec_proj(dec))
            return self.fc(_gelu(enc + dec))
        if enc.dim() == dec.dim() and enc.dim() >= 3:
            A, C = self.factors(enc, dec)
            return A[..., :, None, :] + C[..., None, :, :]
        enc, dec = _broadcast(enc, dec)
        return self.fc(_gelu(torch.cat([enc, dec], dim=-1)))
