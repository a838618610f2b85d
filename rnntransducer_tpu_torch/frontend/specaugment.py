"""SpecAugment inside the training step (port of
``rnntransducer_tpu/frontend/specaugment.py``).

Per utterance: ``freq_cnt`` frequency masks and ``time_cnt`` time masks.
A mask's width is Uniform[0, para) and its start Uniform[0, 1) times
(size - width), as torchaudio's axis masking samples them; masked bins are
set to 0.  With ``feat_lengths`` the time spans are drawn inside each
utterance's valid frames.  The draws come from an explicit
``torch.Generator``: the masks differ from the JAX package's (another
generator), their distribution does not.
"""

from __future__ import annotations

from typing import Optional

import torch


def _span_keep(size: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """(B, size) keep-mask: False on [start, start + width) of each row."""
    idx = torch.arange(size, device=start.device, dtype=torch.float32)[None, :]
    return ~((idx >= start[:, None]) & (idx < (start + width)[:, None]))


def spec_augment(feats: torch.Tensor, generator: torch.Generator,
                 feat_lengths: Optional[torch.Tensor] = None,
                 freq_para: int = 20, time_para: int = 40, freq_cnt: int = 1,
                 time_cnt: int = 1) -> torch.Tensor:
    """feats: (B, T, n_mels) -> feats with the sampled spans zeroed."""
    B, T, M = feats.shape
    dev = feats.device
    if feat_lengths is None:
        valid = torch.full((B,), float(T), device=dev)
    else:
        valid = feat_lengths.to(dev).clamp(1, T).float()

    def draw():
        return torch.rand((B,), device=dev, generator=generator)

    x = feats
    for _ in range(freq_cnt):
        width = draw() * float(freq_para)
        start = draw() * (M - width)
        x = x * _span_keep(M, start, width)[:, None, :].to(x.dtype)
    for _ in range(time_cnt):
        width = torch.minimum(draw() * float(time_para), valid)
        start = draw() * (valid - width).clamp_min(0.0)
        x = x * _span_keep(T, start, width)[:, :, None].to(x.dtype)
    return x
