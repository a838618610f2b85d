"""The RNN-T models of the benchmark's configurations in plain PyTorch.

A model is an encoder, a prediction network and a joint (Graves 2012), each
the module its configuration names (``reference.parts``): the encoders in
``encoders/`` (the reference repository's bidirectional GRU stack, a
chunked-causal Conformer), the prediction networks in ``prednets/``, the
joints in ``joints/``.  This module puts them together: the parameter list,
the weights drawn from a seed, and ``Reference``, the model over those
weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import parts


class Specs(list):
    """(name, shape, init, fan_in) of every parameter, in draw order, and
    which of them the weights' options act on: ``gain`` (the encoder's
    leaves scaled by ``encoder_gain``) and ``output`` (the joint's weight
    and bias that give the logits)."""
    gain: frozenset = frozenset()
    output: Tuple[str, str] = ("", "")


def param_specs(model: Mapping) -> Specs:
    """(name, shape, init, fan_in) of every parameter of ``model`` (the
    ``model`` section of a configuration).  init: "uniform" (+-1/sqrt(fan_in)),
    "normal", "ones", "zeros"."""
    tn, pn, jn = model["transnet"], model["prednet"], model["jointnet"]
    enc, pred, joint = parts.of(model)
    enc_specs = enc.param_specs(tn)
    out = Specs(enc_specs + pred.param_specs(pn)
                + joint.param_specs(jn, tn["output_size"], pn["output_size"]))
    out.gain = frozenset(n for n, _, k, _ in enc_specs if k == "uniform" and enc.takes_gain(n))
    out.output = tuple(joint.OUTPUT)
    return out


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
        self.encoder, self.prednet, self.joint = parts.of(model_cfg)

    # encoder: (B, T, 80) features and frame lengths -> (B, T', De), lengths;
    # ``keeps``: training's dropout masks of the encoder's sites
    def encode(self, feats, lengths, keeps: Sequence[torch.Tensor] = ()
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder.encode(self.P, self.cfg["transnet"], feats,
                                   lengths.to(torch.int64), self.precision, self.remat,
                                   list(keeps))

    # prediction network over blank-prepended labels (B, U+1)
    def predict(self, text_in, text_lengths, keeps: Sequence[torch.Tensor] = ()
                ) -> torch.Tensor:
        return self.prednet.predict(self.P, self.cfg["prednet"], text_in, text_lengths,
                                    self.precision, list(keeps), self.blank)

    def predict_step(self, token, state):
        """One label (N,) through the prediction network from ``state`` (None
        at the start): (dec (N, Dd), new state)."""
        return self.prednet.predict_step(self.P, self.cfg["prednet"], token, state,
                                         self.precision, self.blank)

    def lattice_logprobs(self, enc, dec, labels, keeps: Sequence[torch.Tensor] = ()):
        """Blank and label log-probabilities (B, T, U+1) / (B, T, U);
        ``keeps``: training's dropout masks of the joint's sites."""
        return self.joint.lattice_logprobs(self.P, self.cfg["jointnet"], enc, dec, labels,
                                           self.blank, self.precision, list(keeps))

    # the decode walks: logits[t, u] = A[t] + C[u]
    def _factored(self, name):
        fn = getattr(self.joint, name, None)
        if fn is None:
            raise NotImplementedError(f"the joint {self.joint.__name__} has no factored "
                                      "form A[t] + C[u], which the decode walks read")
        return fn

    def factors(self, enc, dec):
        return self._factored("factors")(self.P, enc, dec, self.precision)

    def enc_factor(self, enc):
        return self._factored("enc_factor")(self.P, enc, self.precision)

    def dec_factor(self, dec):
        return self._factored("dec_factor")(self.P, dec, self.precision)


def seeded_params(specs: Specs, generator: torch.Generator, device, blank_bias: float = 0.0,
                  suppressed: Optional[List[int]] = None, suppress_bias: float = 0.0,
                  blank: int = 0, encoder_gain: float = 1.0,
                  joint_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Weights of ``specs`` from ``generator`` in two large draws (one
    uniform, one normal) on ``device``, float32: uniform leaves in
    +-1/sqrt(fan_in), normal leaves N(0, 1), norms at 1 and 0.  The encoder's
    input-side products (``specs.gain``, which its module names) are scaled
    by ``encoder_gain`` and the joint's output weight by ``joint_scale``; its
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
    for name in specs.gain:
        out[name] *= encoder_gain
    weight, bias_name = specs.output
    out[weight] *= joint_scale
    bias = out[bias_name]
    bias[blank] += blank_bias
    for i in suppressed or []:
        bias[i] += suppress_bias
    return out
