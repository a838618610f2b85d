"""Streaming recognition in the port (decode/streaming.py) against the JAX
package: the incremental frontend against the JAX one (1e-6) and against
the port's offline frontend (1e-5); StreamingRecognizer with each of its
four decoders (greedy, device beam, device beam with a char LM, host beam
with n-gram LM and hotwords) on a unidirectional-LSTM model with the same
weights, tokens exactly; the refusals and the three normalisations."""

import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.decode.device_lm import DeviceCharLM as JaxCharLM
from rnntransducer_tpu.decode.ngram_lm import NGramLM as JaxNGramLM
from rnntransducer_tpu.decode.streaming import StreamingFrontend as JaxFrontend
from rnntransducer_tpu.decode.streaming import StreamingRecognizer as JaxStreaming
from rnntransducer_tpu.tokenizer import GraphemeTokenizer as JaxTokenizer

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.decode import greedy_decode
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.decode.streaming import (StreamingFrontend,
                                                      StreamingRecognizer,
                                                      _zero_encoder_state)
from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import jax_model, model_dict, numpy_params, port_model

# vocab 7: a tokenizer with a delimiter for the host fusion
D = model_dict(rnn_type="lstm", layers=2, bidirectional=False, n_mels=80,
               vocab=7, hidden=16)
VOCAB = {"<pad>": 0, "<unk>": 1, "a": 2, "t": 3, "i": 4, "o": 5, "|": 6}
ARPA = textwrap.dedent(r"""
\data\
ngram 1=6
ngram 2=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.8    at    -0.3
-1.1    it    -0.2
-1.3    to    -0.2
-2.0    <unk>

\2-grams:
-0.4    <s> at
-0.6    at it

\end\
""").strip()
CHAR_ARPA = textwrap.dedent(r"""
\data\
ngram 1=4
ngram 2=2

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.4    a    -0.3
-0.7    t    -0.2

\2-grams:
-0.2    a t
-0.5    t a

\end\
""").strip()


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_model(D, seed=7)
    return jm, variables, port_model(D, variables)


@pytest.fixture(scope="module")
def lm_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_lm")
    (d / "word.arpa").write_text(ARPA)
    (d / "char.arpa").write_text(CHAR_ARPA)
    return str(d / "word.arpa"), str(d / "char.arpa")


def _wave(n=12800, seed=6):
    return (np.random.RandomState(seed).randn(n) * 2).astype(np.float32)


def _stream_frames(frontend, wav, chunk):
    frames = [frontend.feed(wav[s:s + chunk]) for s in range(0, len(wav), chunk)]
    frames.append(frontend.flush())
    return np.concatenate([f for f in frames if len(f)])


@pytest.mark.parametrize("chunk", [160, 1600, 7000])
def test_frontend_matches_jax_and_offline(chunk):
    cfg, jcfg_audio = pcfg.AudioConfig(normalize=False), jcfg.AudioConfig(normalize=False)
    wav = _wave(7350, seed=0)
    got = _stream_frames(StreamingFrontend(cfg), wav, chunk)
    want = _stream_frames(JaxFrontend(jcfg_audio), wav, chunk)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0.0)
    offline, lengths = LogMelFrontend(cfg)(torch.from_numpy(wav[None]))
    assert got.shape == (int(lengths[0]), cfg.n_mels)
    np.testing.assert_allclose(got, offline[0].numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["none", "running", "fixed"])
def test_the_three_normalisations(mode):
    """Each normalisation against the JAX frontend; "fixed" with the
    utterance's own statistics is the offline per-utterance norm."""
    wav = (2.5 * np.random.RandomState(3).randn(7350) + 0.7).astype(np.float32)
    kw = dict(normalize=mode, norm_mean=float(wav.mean()), norm_var=float(wav.var()))
    got = _stream_frames(StreamingFrontend(pcfg.AudioConfig(normalize=True), **kw),
                         wav, 4000)
    want = _stream_frames(JaxFrontend(jcfg.AudioConfig(normalize=True), **kw), wav, 4000)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0.0)
    if mode == "fixed":
        offline, _ = LogMelFrontend(pcfg.AudioConfig(normalize=True))(
            torch.from_numpy(wav[None]))
        np.testing.assert_allclose(got, offline[0].numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="normalization"):
        StreamingFrontend(pcfg.AudioConfig(), normalize="global")


def _feed_all(rec, wav, step=1600):
    out = []
    for s in range(0, len(wav), step):
        out.extend(rec.feed(wav[s:s + step]))
    return out, rec.flush()


@pytest.mark.parametrize("decoder, fusion, chunk_frames", [
    ("greedy", None, 16), ("greedy", None, 64), ("beam", None, 16),
    ("beam", "device_lm", 16), ("beam", "lm+hotwords", 64),
])
def test_streaming_recognizer_matches_jax(models, lm_paths, decoder, fusion,
                                          chunk_frames):
    jm, variables, pm = models
    kw = dict(chunk_frames=chunk_frames, normalize="none", decoder=decoder,
              beam_width=4)
    jkw, pkw = dict(kw), dict(kw)
    if fusion == "device_lm":
        jkw["device_lm"] = JaxCharLM.load(lm_paths[1], JaxTokenizer(VOCAB), weight=1.0)
        pkw["device_lm"] = DeviceCharLM.load(lm_paths[1], GraphemeTokenizer(VOCAB),
                                             weight=1.0)
    elif fusion:
        for k, lm_cls, tok in (("j", JaxNGramLM, JaxTokenizer), ("p", NGramLM,
                                                               GraphemeTokenizer)):
            d = jkw if k == "j" else pkw
            d.update(lm=lm_cls.load(lm_paths[0], weight=0.8, beta=0.5),
                     hotwords=["at"], hotword_weight=2.0, tokenizer=tok(VOCAB))
    wav = _wave()
    ref = JaxStreaming(jm, variables, jcfg.AudioConfig(normalize=False), **jkw)
    rec = StreamingRecognizer(pm, pcfg.AudioConfig(normalize=False), **pkw)
    want_fed, want_final = _feed_all(ref, wav)
    got_fed, got_final = _feed_all(rec, wav)
    assert got_fed == want_fed and got_final == want_final
    assert rec.tokens == ref.tokens and len(ref.tokens) > 0
    if decoder == "greedy":
        assert got_fed + got_final == rec.tokens
        np.testing.assert_allclose(rec.timestamps, ref.timestamps, atol=1e-9)
    else:
        with pytest.raises(ValueError, match="greedy"):
            rec.timestamps


def test_streaming_greedy_equals_offline_greedy(models):
    _, _, pm = models
    wav = _wave(16000, seed=1)
    feats, lengths = LogMelFrontend(pcfg.AudioConfig(normalize=False))(
        torch.from_numpy(wav[None]))
    toks, lens = greedy_decode(pm, feats, lengths, max_output_len=512)
    rec = StreamingRecognizer(pm, pcfg.AudioConfig(normalize=False), chunk_frames=24)
    fed, final = _feed_all(rec, wav)
    assert fed + final == toks[0, :int(lens[0])].tolist() and int(lens[0]) > 0


def test_streaming_refusals_and_state(models, lm_paths):
    _, _, pm = models
    audio = pcfg.AudioConfig()
    bidi = model_dict(rnn_type="lstm", layers=1, bidirectional=True, n_mels=80, vocab=7)
    _, v = jax_model(bidi, seed=0)
    with pytest.raises(ValueError, match="unidirectional"):
        StreamingRecognizer(port_model(bidi, v), audio)
    with pytest.raises(ValueError, match="decoder='beam'"):
        StreamingRecognizer(pm, audio, hotwords=["at"])
    with pytest.raises(ValueError, match="unknown streaming decoder"):
        StreamingRecognizer(pm, audio, decoder="beam_batched")
    lm = DeviceCharLM.load(lm_paths[1], GraphemeTokenizer(VOCAB))
    with pytest.raises(ValueError, match="mutually exclusive"):
        StreamingRecognizer(pm, audio, decoder="beam", device_lm=lm, hotwords=["at"])
    with pytest.raises(ValueError, match="requires decoder='beam'"):
        StreamingRecognizer(pm, audio, device_lm=lm)
    # the carried state is in the params' dtype; a bf16 session copies the model
    state = _zero_encoder_state(pm)
    assert state.h.shape == (2, 1, 1, 16) and state.c.dtype == torch.float32
    rec = StreamingRecognizer(pm, audio, chunk_frames=16, precision="bf16")
    assert next(rec.model.parameters()).dtype == torch.bfloat16
    assert next(pm.parameters()).dtype == torch.float32
    rec.feed(_wave(8000))
    assert rec._enc_state.h.dtype == torch.bfloat16


def test_weight_bridge_takes_the_streaming_model():
    """bench_streaming.py's model (a 6-layer unidirectional LSTM encoder and
    a 2-layer LSTM prediction network), narrowed: the flax params convert,
    and the port's encoder gives the JAX encoder's output."""
    d = model_dict(rnn_type="lstm", layers=6, bidirectional=False, n_mels=80,
                   vocab=72, hidden=16, out=12)
    jm, variables = jax_model(d, seed=2)
    sd = state_dict_from_flax(numpy_params(variables), pcfg.ModelConfig.from_dict(d))
    assert sum(k.startswith("encoder.rnn.fwd.") for k in sd) == 6 * 4
    assert not any(k.startswith("encoder.rnn.bwd.") for k in sd)
    pm = build_model(pcfg.ModelConfig.from_dict(d), "cpu", state_dict=sd)
    x = np.random.RandomState(0).randn(1, 9, 80).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.array([9]),
                               method=jm.encode)[0])
    with torch.inference_mode():
        got = pm.encode(torch.from_numpy(x), torch.tensor([9]))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0.0)


@pytest.mark.cuda
def test_streaming_on_the_card_matches_the_cpu(models):
    """Greedy and beam sessions on CUDA (the LSTM kernel carries h0 / c0
    across chunks, the last chunk ragged) against the CPU, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pm = models
    wav = _wave()
    for decoder in ("greedy", "beam"):
        kw = dict(chunk_frames=16, normalize="none", decoder=decoder)
        want = _feed_all(StreamingRecognizer(pm, pcfg.AudioConfig(normalize=False),
                                             **kw), wav)
        card = pm.to("cuda")
        try:
            got = _feed_all(StreamingRecognizer(
                card, pcfg.AudioConfig(normalize=False), **kw), wav)
        finally:
            pm.to("cpu")
        assert got == want
