"""RNN-Transducer model: encoder + prediction net + joint (port of
``rnntransducer_tpu/models/transducer.py``), and ``build_model``."""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
from torch import nn

from rnntransducer_tpu_torch.config import Config, ModelConfig
from rnntransducer_tpu_torch.models.cells import RNNState, remat_active, remat_call
from rnntransducer_tpu_torch.models.conformer import ConformerEncoder
from rnntransducer_tpu_torch.models.encoder import AudioEncoder
from rnntransducer_tpu_torch.models.joint import JointNetwork
from rnntransducer_tpu_torch.models.prednet import PredictionNet
from rnntransducer_tpu_torch.utils.device import resolve_device


class RNNTransducer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = (ConformerEncoder(cfg.transnet) if cfg.transnet.arch == "conformer"
                        else AudioEncoder(cfg.transnet))
        self.prednet = PredictionNet(cfg.prednet)
        self.joint = JointNetwork(cfg.jointnet, cfg.transnet.output_size,
                                  cfg.prednet.output_size)

    def forward(self, audio, audio_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None):
        """audio: (B, T, n_mels); text: (B, U+1) blank-prepended labels.
        Returns (B, T', U+1, V) logits.  ``generator`` turns dropout on.
        ``jointnet.remat``: the joint's (B, T', U+1, De+Dd) lattice is
        recomputed in the backward pass instead of kept, as in the JAX
        model."""
        enc, _ = self.encoder(audio, audio_lengths, generator=generator)
        dec, _ = self.prednet(text, text_lengths, generator=generator)
        return self.joint_lattice(enc, dec)

    def encode(self, audio, audio_lengths=None, initial_state: Optional[RNNState] = None,
               generator: Optional[torch.Generator] = None):
        return self.encoder(audio, audio_lengths, initial_state, generator)

    def predict(self, text, text_lengths=None, initial_state: Optional[RNNState] = None,
                generator: Optional[torch.Generator] = None):
        return self.prednet(text, text_lengths, initial_state, generator)

    def predict_step(self, token, state: Optional[RNNState]):
        return self.prednet.step(token, state)

    def joint_step(self, enc_t, dec_u):
        """enc_t (B, De), dec_u (B, Dd) -> (B, V) logits."""
        return self.joint(enc_t, dec_u)

    def joint_lattice(self, enc, dec):
        """enc (B, T', De), dec (B, U+1, Dd) -> (B, T', U+1, V) logits, the
        lattice recomputed in the backward pass under ``jointnet.remat``."""
        if remat_active(self.cfg.jointnet.remat, self.joint, enc):
            return remat_call(self.joint, enc, dec)
        return self.joint(enc, dec)

    def joint_factors(self, enc, dec, shard=None):
        return self.joint.factors(enc, dec, shard)


def build_model(cfg: Union[Config, ModelConfig], device=None,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                trainable: bool = False) -> RNNTransducer:
    """An ``RNNTransducer`` on ``device`` (default CUDA; raises when CUDA is
    absent and no device is named).  Weights come from ``state_dict``, else
    are random from seed 0.  By default the model is frozen and in eval
    mode (serving); ``trainable=True`` gives float32 params that require
    grad, in train mode."""
    from rnntransducer_tpu_torch.utils.weights import (random_flax_params,
                                                       state_dict_from_flax)
    device = resolve_device(device)
    model_cfg = cfg.model if isinstance(cfg, Config) else cfg
    with torch.device("meta"):
        model = RNNTransducer(model_cfg)
    model = model.to_empty(device=device)
    if state_dict is None:
        state_dict = state_dict_from_flax(
            random_flax_params(model_cfg, torch.Generator().manual_seed(0)),
            model_cfg)
    model.load_state_dict(state_dict)
    if trainable:
        return model.float().requires_grad_(True).train()
    model.requires_grad_(False)
    return model.eval()
