"""The port's batched device beam (decode/beam_batched.py) against the JAX
package's on a tiny unidirectional-LSTM model with the same weights, fp32:
tokens and lengths exactly, scores to 1e-5 relative; beam width 1 against
greedy decoding; a beam carried over two chunks against one pass."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.decode.beam_batched import batched_beam_decode as jax_beam

from rnntransducer_tpu_torch.decode import greedy_decode
from rnntransducer_tpu_torch.decode.beam_batched import (
    _top_k, batched_beam_decode, beam_decode_frames, best_hyp, best_hyp_all,
    init_beam_carry, rank_beam)
from rnntransducer_tpu_torch.decode.greedy import _encode

from _torch_parity import jax_model, model_dict, port_model, t

SCORE_RTOL = 1e-5
D = model_dict(rnn_type="lstm", layers=2, bidirectional=False, vocab=11)


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model(D, seed=3)
    return jm, variables, port_model(D, variables)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = (rng.randn(3, 20, 8) * 2).astype(np.float32)
    return feats, np.array([20, 13, 5], np.int32)


def assert_same_beam(got, want):
    (gt, gl, gs), (wt, wl, ws) = got, [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gt.numpy(), wt)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=SCORE_RTOL, atol=0.0)


@pytest.mark.parametrize("beam_width, kw", [
    (1, {}), (4, {}), (4, dict(merge_duplicates=True)),
    (4, dict(length_norm_alpha=0.5)), (3, dict(max_symbols=1, length_norm=False)),
])
def test_batched_beam_matches_jax(models, beam_width, kw):
    jm, variables, pm = models
    feats, lengths = _inputs()
    want = jax_beam(jm, variables, jnp.asarray(feats), jnp.asarray(lengths),
                    beam_width=beam_width, max_output_len=32, **kw)
    got = batched_beam_decode(pm, t(feats), t(lengths), beam_width=beam_width,
                              max_output_len=32, **kw)
    assert int(np.asarray(want[1])[:, 0].sum()) > 0  # the comparison has tokens
    assert_same_beam(got, want)


def test_beam_width_one_is_greedy(models):
    _, _, pm = models
    feats, lengths = _inputs(seed=1)
    toks, lens, _ = batched_beam_decode(pm, t(feats), t(lengths), beam_width=1,
                                        max_output_len=32)
    g_toks, g_lens = greedy_decode(pm, t(feats), t(lengths), max_output_len=32)
    assert int(g_lens.sum()) > 0
    assert torch.equal(lens[:, 0], g_lens) and torch.equal(toks[:, 0], g_toks)


def test_two_chunks_equal_one_pass(models):
    """The carry resumes: frames [0, 9) then [9, 20) (with each utterance's
    valid frames per chunk) give the one-pass beam."""
    _, _, pm = models
    feats, lengths = _inputs(seed=2)
    enc, enc_len = _encode(pm, t(feats), t(lengths))
    one = beam_decode_frames(pm, enc, enc_len, init_beam_carry(pm, 3, 4, 0, 32))
    carry = init_beam_carry(pm, 3, 4, 0, 32)
    carry = beam_decode_frames(pm, enc[:, :9], enc_len.clamp(max=9), carry)
    carry = beam_decode_frames(pm, enc[:, 9:], (enc_len - 9).clamp(min=0), carry)
    for a, b in zip(rank_beam(one), rank_beam(carry)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(best_hyp_all(one), best_hyp_all(carry)))
    tok0, n0 = best_hyp(carry)
    assert torch.equal(tok0, best_hyp_all(carry)[0][0]) and int(n0) > 0


def test_top_k_puts_the_lower_index_first_among_ties():
    pool = torch.tensor([[-1e30, 2.0, -1e30, 2.0, 5.0, -1e30]])
    values, idx = _top_k(pool, 5)
    assert idx.tolist() == [[4, 1, 3, 0, 2]]
    assert values[0, 3] == values[0, 4] == torch.tensor(-1e30)


@pytest.mark.cuda
def test_batched_beam_on_the_card_matches_the_cpu(models):
    """The device beam on CUDA (the LSTM kernel in the encoder) against the
    same decode on the CPU, fp32: tokens exactly, scores to 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm = models
    feats, lengths = _inputs()
    want = batched_beam_decode(pm, t(feats), t(lengths), beam_width=4, max_output_len=32)
    got = batched_beam_decode(pm.to("cuda"), t(feats).cuda(), t(lengths).cuda(),
                              beam_width=4, max_output_len=32)
    pm.to("cpu")
    assert_same_beam([x.cpu() for x in got], [x.numpy() for x in want])
