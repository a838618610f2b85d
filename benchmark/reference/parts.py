"""The reference's parts, found by the configuration's own names.

* the encoder by ``transnet.arch`` (default ``rnn``): ``encoders/<arch>.py``;
* the prediction network by ``prednet.rnn_type``: ``prednets/<kind>.py``;
* the joint by ``jointnet.combine`` (default ``concat``): ``joints/<combine>.py``.

A configuration whose encoder, prediction network or joint the benchmark has
not seen brings it as a new module in these directories, and its FLOP count
as one in ``benchmark/roofline/`` (``roofline.counts``): no file already
there needs an edit.  What each module gives:

* encoder: ``param_specs(tn)``; ``takes_gain(name)``, whether an encoder
  weight is scaled by the configuration's ``encoder_gain``;
  ``dropout_sites(tn)``, the rate of each dropout mask a training step
  draws in the encoder, in the program's call order; ``encode(P, tn,
  feats, lengths, precision, remat, keeps)`` -> (encoder output, its
  lengths), ``keeps`` the step's keep masks of those sites (none: no
  dropout).
* prediction network: ``param_specs(pn)``; ``dropout_sites(pn)``;
  ``predict(P, pn, text_in, text_lengths, precision, keeps, blank)``; and
  for the decode walks ``predict_step(P, pn, token, state, precision,
  blank)`` -> (output, new state).
* joint: ``param_specs(jn, enc_size, dec_size)``; ``OUTPUT``, the names
  of the weight and bias that give the logits (the configuration's
  ``joint_scale`` and biases go there); ``dropout_sites(jn)``;
  ``lattice_logprobs(P, jn, enc, dec, labels, blank, precision, keeps)`` ->
  blank and label log-probabilities (B, T, U+1) / (B, T, U), a joint that
  does not factor in row blocks (``loss.in_row_blocks``); and, for the decode
  walks, a factored form ``factors`` / ``enc_factor`` / ``dec_factor``
  (logits[t, u] = A[t] + C[u]) where the joint has one.

Parameters are (name, shape, init, fan_in) tuples in draw order (see
``model.seeded_params``); names are the keys of the state dict both sides
are given.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType
from typing import Mapping, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
PART_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")
#: part -> (configuration section, key, default, directory under reference/)
PARTS = {"encoder": ("transnet", "arch", "rnn", "encoders"),
         "prednet": ("prednet", "rnn_type", None, "prednets"),
         "joint": ("jointnet", "combine", "concat", "joints")}


class MissingPart(LookupError):
    """A configuration names a part that has no module of its own."""


def find_module(package: str, directory: Path, what: str, name) -> ModuleType:
    """``<package>.<name>``, the module of ``directory/<name>.py``;
    ``MissingPart`` naming that file where it is not there."""
    path = directory / f"{name}.py"
    if isinstance(name, str) and PART_NAME.match(name) and path.is_file():
        return importlib.import_module(f"{package}.{name}")
    raise MissingPart(f"{what} = {name!r} has no module: add {path.relative_to(ROOT)} "
                      "(a part's name is letters, digits and _, from a letter)")


def name_of(model: Mapping, part: str):
    section, key, default, _ = PARTS[part]
    return model[section].get(key, default)


def part(model: Mapping, which: str) -> ModuleType:
    """The reference module of ``model``'s encoder, prednet or joint."""
    section, key, _, directory = PARTS[which]
    return find_module(f"benchmark.reference.{directory}", HERE / directory,
                       f"{section}.{key}", name_of(model, which))


def of(model: Mapping) -> Tuple[ModuleType, ModuleType, ModuleType]:
    """(encoder, prediction network, joint) modules of ``model``."""
    return part(model, "encoder"), part(model, "prednet"), part(model, "joint")
