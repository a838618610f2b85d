"""The concat joint of the reference repository (``networks/transducer.py``):
``fc(gelu_tanh([enc; dec]))``.  The GELU acts on each side alone, so the
logits factor: ``logits[t, u] = A[t] + C[u]`` with A the fc's encoder
columns over the encoder side and C its prediction-network columns (and
the bias) over the other; the lattice and the decode walks use the
factors."""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from benchmark.reference import loss
from benchmark.reference.layers import Spec, linear_specs
from benchmark.reference.precision import linear

#: the weight and bias that give the logits
OUTPUT = ("joint.fc.weight", "joint.fc.bias")


def param_specs(jn, enc_size: int, dec_size: int) -> List[Spec]:
    return linear_specs("joint.fc", enc_size + dec_size, jn["num_classes"])


def dropout_sites(jn) -> List[float]:
    return []


def factors(P, enc, dec, precision):
    w = P["joint.fc.weight"]
    De = enc.shape[-1]
    ge = F.gelu(enc, approximate="tanh")
    gd = F.gelu(dec, approximate="tanh")
    return (linear(ge, w[:, :De], None, precision),
            linear(gd, w[:, De:], P["joint.fc.bias"], precision))


def enc_factor(P, enc, precision):
    return factors(P, enc, enc.new_zeros(enc.shape[:-1] + (
        P["joint.fc.weight"].shape[1] - enc.shape[-1],)), precision)[0]


def dec_factor(P, dec, precision):
    De = P["joint.fc.weight"].shape[1] - dec.shape[-1]
    return factors(P, dec.new_zeros(dec.shape[:-1] + (De,)), dec, precision)[1]


def lattice_logprobs(P, jn, enc, dec, labels, blank, precision, keeps):
    A, C = factors(P, enc, dec, precision)
    return loss.lattice_logprobs(A, C, labels, blank)
