"""Label-looping greedy decoding (decode/greedy.py::
greedy_decode_label_looping) against the port's frame scan and the JAX
package's label-looping decoder, same weights, fp32: the tokens and lengths
must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest

from rnntransducer_tpu.decode.greedy import (
    greedy_decode_label_looping as jax_label_looping)
from rnntransducer_tpu_torch.decode import greedy as greedy_mod
from rnntransducer_tpu_torch.decode import greedy_decode, greedy_decode_label_looping

from _torch_parity import jax_model, model_dict, port_model, t


@pytest.mark.parametrize("max_symbols, stride, check_every",
                         [(3, 1, 8), (1, 1, 1), (3, 2, 3)])
def test_label_looping_equals_the_frame_scan_and_jax(max_symbols, stride, check_every,
                                                     monkeypatch):
    """``check_every``: iterations between the host's reads of whether the
    batch is done (the iterations after it is done must change nothing)."""
    monkeypatch.setattr(greedy_mod, "_CHECK_EVERY", check_every)
    d = model_dict(stride=stride, reduce_at=1, layers=2)
    jm, variables = jax_model(d, seed=4)
    pm = port_model(d, variables)
    rng = np.random.RandomState(9)
    feats = rng.randn(4, 14, 8).astype(np.float32)
    lengths = np.array([14, 7, 3, 0], np.int32)
    kw = dict(blank_id=0, max_symbols=max_symbols, max_output_len=32)
    got_tok, got_len = greedy_decode_label_looping(pm, t(feats), t(lengths), **kw)
    scan_tok, scan_len = greedy_decode(pm, t(feats), t(lengths), **kw)
    want_tok, want_len = jax_label_looping(jm, variables, jnp.asarray(feats),
                                           jnp.asarray(lengths), **kw)
    assert int(np.asarray(want_len).sum()) > 0  # the comparison has tokens
    np.testing.assert_array_equal(got_len.numpy(), scan_len.numpy())
    np.testing.assert_array_equal(got_tok.numpy(), scan_tok.numpy())
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
