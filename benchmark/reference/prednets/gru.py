"""The recurrent prediction network with GRU layers: as ``prednets/lstm.py``
in training; the decode walks step LSTM prediction networks only."""

from benchmark.reference.prednets.lstm import dropout_sites, param_specs, predict  # noqa: F401


def predict_step(P, pn, token, state, precision, blank):
    raise ValueError("the reference decodes LSTM prediction networks")
