"""Audio encoder (port of ``rnntransducer_tpu/models/encoder.py``).

Multi-layer (bi)directional RNN over log-mel frames, then an output
projection.  Time reduction (``time_reduction_stride > 1``): after
``time_reduction_layer`` layers every ``stride`` consecutive frames are
stacked into one, so the remaining layers and everything downstream run at
1/stride the frame rate; a reduced group is valid if any of its frames is.
With a ``generator`` (training), inter-layer dropout runs inside each stack
and once more at the stack boundary (``boundary_drop``), as torch applies
dropout to every layer's output but the last.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnntransducer_tpu_torch.config import TransNetConfig
from rnntransducer_tpu_torch.models.cells import RNNState, StackedRNN, fast_dropout
from rnntransducer_tpu_torch.utils.masking import length_mask


def stack_frames(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T, F) -> (B, ceil(T/stride), stride*F), zero-padding a ragged
    tail group."""
    if stride <= 1:
        return x
    B, T, Fd = x.shape
    pad = (-T) % stride
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(B, (T + pad) // stride, stride * Fd)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: TransNetConfig):
        super().__init__()
        if cfg.arch != "rnn":
            raise ValueError(
                f"AudioEncoder is the RNN encoder; arch {cfg.arch!r} is "
                "models.conformer.ConformerEncoder")
        self.cfg = cfg
        stride = cfg.time_reduction_stride
        k = cfg.time_reduction_layer if stride > 1 else 0
        dirs = 2 if cfg.bidirectional else 1
        rnn_type = cfg.rnn_type.lower()

        def make_stack(input_size, num_layers):
            return StackedRNN(input_size, cfg.hidden_size, num_layers, rnn_type,
                              cfg.bidirectional, cfg.dropout, cfg.remat)

        # "rnn" = layers before the reduction point, "rnn_post" = after it
        if stride > 1 and 0 < k < cfg.num_layers:
            self.rnn = make_stack(cfg.input_size, k)
            self.rnn_post = make_stack(stride * dirs * cfg.hidden_size,
                                       cfg.num_layers - k)
        else:
            in_size = cfg.input_size * (stride if stride > 1 and k == 0 else 1)
            self.rnn = make_stack(in_size, cfg.num_layers)
            self.rnn_post = None
        proj_in = dirs * cfg.hidden_size * (
            stride if stride > 1 and k == cfg.num_layers else 1)
        self.out_proj = nn.Linear(proj_in, cfg.output_size)

    def boundary_drop(self, x, generator: Optional[torch.Generator]):
        """Dropout on the stacked frames between ``rnn`` and ``rnn_post``."""
        return fast_dropout(x, self.cfg.dropout, generator)

    def forward(self, inputs, lengths=None, initial_state: Optional[RNNState] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, RNNState]:
        """inputs: (B, T, n_mels). Returns ((B, T', output_size), state) with
        T' = cfg.output_frames(T).  ``generator`` turns dropout on."""
        cfg = self.cfg
        stride = cfg.time_reduction_stride
        if stride <= 1:
            out, state = self.rnn(inputs, lengths, initial_state, generator)
            return self.out_proj(out), state

        k = cfg.time_reduction_layer
        red_lengths = None if lengths is None else cfg.output_lengths(
            lengths.to(torch.int64))
        if k == 0:
            # zero frames past each row's length before stacking: the last
            # valid group may straddle the boundary
            if lengths is not None:
                valid = length_mask(lengths, inputs.shape[1])
                inputs = torch.where(valid[..., None], inputs, 0.0)
            out, state = self.rnn(stack_frames(inputs, stride), red_lengths,
                                  initial_state, generator)
        elif k == cfg.num_layers:
            out, state = self.rnn(inputs, lengths, initial_state, generator)
            out = stack_frames(out, stride)
        else:
            pre_state = post_state = None
            if initial_state is not None:
                c = initial_state.c
                pre_state = RNNState(initial_state.h[:k], None if c is None else c[:k])
                post_state = RNNState(initial_state.h[k:], None if c is None else c[k:])
            out, s_pre = self.rnn(inputs, lengths, pre_state, generator)
            out = self.boundary_drop(stack_frames(out, stride), generator)
            out, s_post = self.rnn_post(out, red_lengths, post_state, generator)
            state = RNNState(
                torch.cat([s_pre.h, s_post.h], dim=0),
                None if s_pre.c is None else torch.cat([s_pre.c, s_post.c], dim=0))
        return self.out_proj(out), state
