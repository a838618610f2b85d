"""Streaming recognition (port of ``rnntransducer_tpu/decode/streaming.py``):
a chunked log-mel frontend, a unidirectional encoder carrying its
``RNNState`` across chunks, and a resumable decoder.

* ``StreamingFrontend``: incremental STFT / mel on the host (numpy) with
  an overlap buffer; its frames are the offline frontend's (the same
  center / reflect padding, realised at the stream's start and at
  ``flush()``);
* ``StreamingRecognizer``: feeds audio through the frontend, the encoder
  (one chunk of ``chunk_frames`` feature frames at a time, the final
  partial chunk padded and masked by its valid length; a unidirectional
  RNN or the chunked-causal Conformer, whose chunk is exactly one
  attention chunk) and one of four
  decoders: the greedy carry, the device beam carry, the device beam with
  a char LM table, or the host A/B beam with n-gram LM and hotword fusion.

The carried encoder state is stored in the params' dtype between chunks,
as the JAX package does; inside a chunk the recurrent kernels carry fp32.

Per-utterance mean-var normalisation needs the whole utterance; streaming
offers ``normalize="none"`` (a model trained without normalisation),
``"running"`` (causal running mean / var) or ``"fixed"`` (calibrated
corpus mean / var).
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.decode.beam_batched import (beam_decode_frames,
                                                         best_hyp,
                                                         init_beam_carry)
from rnntransducer_tpu_torch.decode.greedy import (_device,
                                                   greedy_decode_frames,
                                                   init_greedy_carry)
from rnntransducer_tpu_torch.frontend.melspec import WINDOWS, mel_filterbank
from rnntransducer_tpu_torch.models.cells import RNNState
from rnntransducer_tpu_torch.models.transducer import RNNTransducer
from rnntransducer_tpu_torch.utils.precision import (decode_dtype,
                                                     match_param_dtype,
                                                     param_dtype)


class StreamingFrontend:
    """Incremental log-mel.  feed(samples) -> (n, n_mels) new frames;
    flush() -> the trailing frames (with the right-side reflect pad)."""

    def __init__(self, cfg: AudioConfig, normalize: str = "none",
                 norm_mean: float = 0.0, norm_var: float = 1.0):
        if normalize not in ("none", "running", "fixed"):
            raise ValueError(f"unknown streaming normalization {normalize!r}")
        self.cfg = cfg
        self.normalize = normalize
        # "fixed": calibrated corpus-level statistics (global CMVN)
        self.norm_mean = norm_mean
        self.norm_var = norm_var
        self.window = WINDOWS[cfg.window](cfg.win_length)
        self.fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate)
        self.reset()

    def reset(self):
        self._buf = np.zeros((0,), np.float32)
        self._buf_start = 0        # absolute sample index of _buf[0]
        self._next_frame = 0
        self._total = 0
        self._sum = 0.0
        self._sumsq = 0.0

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        if self.normalize == "none" or self._total == 0:
            return x
        if self.normalize == "fixed":
            mean, var = self.norm_mean, self.norm_var
        else:
            mean = self._sum / self._total
            var = max(self._sumsq / self._total - mean * mean, 0.0)
        return (x - mean) / np.sqrt(var + 1e-7)

    def _frames_between(self, first: int, last: int) -> np.ndarray:
        """Frames [first, last) from the buffer, with the stream-start
        reflect pad where windows reach before sample 0."""
        cfg = self.cfg
        pad = cfg.n_fft // 2
        if last <= first or self._total == 0:
            return np.zeros((0, cfg.n_mels), np.float32)
        out = np.zeros((last - first, cfg.n_fft), np.float32)
        for j, i in enumerate(range(first, last)):
            s = i * cfg.hop_length - pad
            idx = np.arange(s, s + cfg.n_fft)
            idx = np.where(idx < 0, -idx, idx)  # reflect at the stream start
            over = idx - (self._total - 1)      # reflect at the end (flush only)
            idx = np.where(over > 0, self._total - 1 - over, idx)
            # very short streams (total < pad): clamp, never wrap negatively
            idx = np.clip(idx, self._buf_start,
                          self._buf_start + len(self._buf) - 1)
            out[j] = self._buf[idx - self._buf_start]
        spec = np.fft.rfft(self._normalize(out) * self.window[None, :], axis=-1)
        power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
        return np.log1p(power @ self.fb)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        samples = np.asarray(samples, np.float32)
        self._buf = np.concatenate([self._buf, samples])
        self._total += len(samples)
        self._sum += float(samples.sum())
        self._sumsq += float((samples ** 2).sum())
        cfg = self.cfg
        pad = cfg.n_fft // 2
        # frames fully determined without right-side padding:
        # i*hop - pad + n_fft <= total
        last = max((self._total - cfg.n_fft + pad) // cfg.hop_length + 1,
                   self._next_frame)
        feats = self._frames_between(self._next_frame, last)
        self._next_frame = last
        # trim consumed samples: future windows reach back to
        # next_frame*hop - pad, flush()'s end reflection to total-1-pad
        keep_from = max(0, min(self._next_frame * cfg.hop_length - pad,
                               self._total - 1 - pad))
        if keep_from > self._buf_start:
            self._buf = self._buf[keep_from - self._buf_start:]
            self._buf_start = keep_from
        return feats

    def flush(self) -> np.ndarray:
        """The final frames, as the offline frontend gives them: total //
        hop + 1 frames overall."""
        last = max(self._total // self.cfg.hop_length + 1, self._next_frame)
        feats = self._frames_between(self._next_frame, last)
        self._next_frame = last
        return feats


def _zero_encoder_state(model: RNNTransducer, batch: int = 1) -> RNNState:
    """The encoder's zero state on the model's device, in the params' dtype
    (the state carried between chunks keeps that dtype).  The Conformer's
    is its block cache: h (L, left*C, B, d+1), the attention window with a
    validity flag channel, and c (L, K-1, B, d), the conv tail, two tensors
    of their own.  An LSTM encoder gets one tensor as h and c."""
    cfg = model.cfg.transnet
    dtype, device = param_dtype(model), _device(model)
    if cfg.arch == "conformer":
        return model.encoder.zero_state(batch, dtype, device)
    d = 2 if cfg.bidirectional else 1
    h = torch.zeros((cfg.num_layers, d, batch, cfg.hidden_size),
                    dtype=dtype, device=device)
    return RNNState(h, h if cfg.rnn_type.lower() == "lstm" else None)


def check_chunk_frames(cfg, chunk_frames: int) -> None:
    """The streaming surfaces' chunk checks: reduced groups align across
    chunks, and a streaming Conformer takes exactly one attention chunk per
    call."""
    stride = cfg.time_reduction_stride
    if stride > 1 and chunk_frames % stride:
        raise ValueError(
            f"chunk_frames ({chunk_frames}) must be a multiple of "
            f"time_reduction_stride ({stride}) so reduced groups align "
            "across chunks")
    if cfg.arch == "conformer" and chunk_frames != cfg.attention_chunk * stride:
        raise ValueError(
            f"the streaming Conformer consumes exactly one attention chunk "
            f"per step: chunk_frames must be attention_chunk*stride = "
            f"{cfg.attention_chunk * stride}, got {chunk_frames}")


@torch.inference_mode()
def _encode_chunk(model: RNNTransducer, chunk: torch.Tensor, n_valid: torch.Tensor,
                 state: RNNState):
    """One chunk (1, chunk_frames, n_mels) through the encoder from
    ``state``: (enc, new_state); the layers return the state in the dtype
    they were given it, the params'."""
    return model.encode(match_param_dtype(model, chunk), n_valid, state)


class StreamingRecognizer:
    """Chunked streaming ASR session over a unidirectional-encoder model.

    decoder="greedy": feed() returns the newly emitted token ids.
    decoder="beam": feed() returns [] (a ranked best every chunk would cost
    a device-to-host round trip); poll ``.tokens``; flush() returns the
    final best hypothesis.

    LM / hotword fusion: ``lm`` (``decode.ngram_lm.NGramLM``) and / or
    ``hotwords`` with decoder="beam" and a ``tokenizer`` run the host A/B
    search (``decode/beam.py``), resumed over encoder chunks, so streaming
    beam + LM output equals the offline host beam + LM output.

    Device fusion: ``device_lm`` (``decode.device_lm.DeviceCharLM``) with
    decoder="beam" instead; the table is gathered inside the device beam's
    frame loop.  It excludes the host ``lm`` / ``hotwords``.
    """

    def __init__(self, model: RNNTransducer, audio_cfg: AudioConfig,
                 blank_id: int = 0, chunk_frames: int = 64,
                 max_symbols: int = 3, max_output_len: int = 512,
                 normalize: str = "none", decoder: str = "greedy",
                 beam_width: int = 4, norm_mean: float = 0.0,
                 norm_var: float = 1.0, lm=None,
                 hotwords=None, hotword_weight: Optional[float] = None,
                 tokenizer=None, improved: bool = True,
                 state_beam: float = 4.6, expand_beam: float = 2.3,
                 device_lm=None, precision: Optional[str] = None):
        tn = model.cfg.transnet
        if tn.bidirectional:
            raise ValueError(
                "streaming requires a unidirectional encoder "
                "(transnet.bidirectional=false)")
        check_chunk_frames(tn, chunk_frames)
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"unknown streaming decoder: {decoder}")
        fused = lm is not None or bool(hotwords)
        if fused and decoder != "beam":
            raise ValueError("LM/hotword fusion requires decoder='beam'")
        if device_lm is not None:
            if decoder != "beam":
                raise ValueError("device_lm requires decoder='beam'")
            if fused:
                raise ValueError(
                    "device_lm (on-device char fusion) and lm/hotwords "
                    "(host word-level fusion) are mutually exclusive")
        # precision='bf16': a bf16 copy of the weights; None keeps the model's
        if precision is not None and decode_dtype(precision) != param_dtype(model):
            model = copy.deepcopy(model).to(decode_dtype(precision))
        self.model = model
        self.blank_id = blank_id
        self.chunk_frames = chunk_frames
        self.max_symbols = max_symbols
        self.decoder = decoder
        self.beam_width = beam_width
        self.frontend = StreamingFrontend(audio_cfg, normalize,
                                          norm_mean=norm_mean, norm_var=norm_var)
        self._device = _device(model)
        self._feat_buf = np.zeros((0, audio_cfg.n_mels), np.float32)
        self._enc_state: Optional[RNNState] = None
        self._host_beam = None
        self._final_tokens: Optional[List[int]] = None
        self._lm_table = (device_lm.to(self._device).table
                          if device_lm is not None else None)
        self._lm_weight = device_lm.weight if device_lm is not None else 0.0
        if fused:
            from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
            from rnntransducer_tpu_torch.decode.hotwords import DEFAULT_HOTWORD_WEIGHT
            self._host_beam = BeamSearchDecoder(
                model, blank_id=blank_id, tokenizer=tokenizer,
                beam_width=beam_width, improved=improved,
                state_beam=state_beam, expand_beam=expand_beam, lm=lm,
                hotwords=hotwords,
                hotword_weight=(DEFAULT_HOTWORD_WEIGHT if hotword_weight
                                is None else hotword_weight))
            self._carry = self._host_beam.open_session()
        elif decoder == "beam":
            self._carry = init_beam_carry(
                model, 1, beam_width, blank_id, max_output_len,
                lm_context=device_lm.context if device_lm is not None else 0)
        else:
            self._carry = init_greedy_carry(model, 1, blank_id, max_output_len)
        self._emitted = 0

    # ------------------------------------------------------------------
    def _run_chunks(self, final: bool) -> List[int]:
        new_tokens: List[int] = []
        while len(self._feat_buf) >= self.chunk_frames or (
                final and len(self._feat_buf) > 0):
            chunk = self._feat_buf[:self.chunk_frames]
            self._feat_buf = self._feat_buf[self.chunk_frames:]
            n_valid = len(chunk)
            if n_valid < self.chunk_frames:  # the final partial chunk: pad
                chunk = np.pad(chunk, ((0, self.chunk_frames - n_valid), (0, 0)))
            if self._enc_state is None:
                self._enc_state = _zero_encoder_state(self.model)
            enc, self._enc_state = _encode_chunk(
                self.model, torch.from_numpy(chunk[None]).to(self._device),
                torch.tensor([n_valid], device=self._device), self._enc_state)
            # time reduction: the encoder emits ceil(n / stride) frames
            n_enc = int(self.model.cfg.transnet.output_lengths(n_valid))
            n_enc_t = torch.tensor([n_enc], device=self._device)
            if self._host_beam is not None:
                # the fused search is host-side; the chunk's valid frames
                # stay on the device, each wave reads its frame there
                self._host_beam.decode_frames(self._carry, enc[0, :n_enc])
            elif self.decoder == "beam":
                # partials on demand via .tokens: no per-chunk host read
                self._carry = beam_decode_frames(
                    self.model, enc, n_enc_t, self._carry, self.blank_id,
                    self.max_symbols, lm_table=self._lm_table,
                    lm_weight=self._lm_weight)
            else:
                self._carry = greedy_decode_frames(
                    self.model, enc, n_enc_t, self._carry, self.blank_id,
                    self.max_symbols)
                total = int(self._carry.lengths[0])
                new_tokens.extend(
                    self._carry.tokens[0, self._emitted:total].tolist())
                self._emitted = total
        if final and self.decoder == "beam":
            if self._host_beam is not None and self._final_tokens is None:
                # settle the EOS LM scoring once; .tokens serves it after
                self._final_tokens = self._host_beam.finalize(self._carry)[0]
            new_tokens = self.tokens
        return new_tokens

    def feed(self, samples: np.ndarray) -> List[int]:
        """Feed PCM samples; returns the newly emitted token ids."""
        feats = self.frontend.feed(samples)
        if len(feats):
            self._feat_buf = np.concatenate([self._feat_buf, feats])
        return self._run_chunks(final=False)

    def flush(self) -> List[int]:
        """End of stream: drain the remaining frames (with the right
        reflect pad)."""
        feats = self.frontend.flush()
        if len(feats):
            self._feat_buf = np.concatenate([self._feat_buf, feats])
        return self._run_chunks(final=True)

    @property
    def tokens(self) -> List[int]:
        if self._host_beam is not None:
            if self._final_tokens is not None:
                return list(self._final_tokens)
            return self._host_beam.current_best(self._carry)
        if self.decoder == "beam":
            best, n = best_hyp(self._carry)
            return best[:int(n)].tolist()
        n = int(self._carry.lengths[0])
        return self._carry.tokens[0, :n].tolist()

    @property
    def timestamps(self) -> List[float]:
        """Per-token emission times in seconds (greedy sessions only: beam
        hypotheses can be rewritten), parallel to ``.tokens``."""
        if self.decoder != "greedy":
            raise ValueError("timestamps are available for greedy sessions")
        n = int(self._carry.lengths[0])
        sec = (self.model.cfg.transnet.time_reduction_stride
               * self.frontend.cfg.window_stride_sec)
        return [float(t) * sec for t in self._carry.times[0, :n].tolist()]
