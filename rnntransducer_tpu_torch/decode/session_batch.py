"""Continuous batching for streaming sessions (port of
``rnntransducer_tpu/decode/session_batch.py``): one device call serves many
live sessions.

``StreamingRecognizer`` runs the encoder at batch 1 for every session and
chunk.  This module multiplexes up to ``max_sessions`` concurrent sessions
onto one (max_sessions, chunk_frames) tick:

* every session owns a batch SLOT; its encoder ``RNNState`` and decode
  carry live as one lane of persistent batched state on the model's device;
* a TICK gathers one pending chunk from every ready session, runs one
  encode + decode step over the full width (the recurrent encoder layers
  are one kernel launch each, whatever the width), and fetches every
  lane's tokens with a single device-to-host copy;
* sessions with nothing pending ride along as no-ops: their ``n_valid`` is
  0, the masked encoder scan keeps a length-0 row's h and c (the streaming
  Conformer's cache is kept by a per-lane select, ``_batched_encode``), and
  the decoders' ``t < enc_lengths`` gates keep its carry, bit for bit.

Per-session results equal an independent ``StreamingRecognizer`` fed the
same audio in the same pieces.  Both streaming decoders are supported:
``decoder="greedy"`` (monotone emission from ``feed``) and
``decoder="beam"`` (frame-synchronous beam lanes of ``beam_width``
hypotheses each, rows slot-major: lane s holds rows s*K .. s*K+K-1; poll
``.tokens`` for the ranked best, which can rewrite).  With ``lm`` /
``hotwords`` the beam lanes run the host A/B search and the tick encodes
only.

Lane sharding (``mesh``, a list of devices): the lanes split into one group
per device, slot-major, each group with its own copy of the model and its
slice of the state; a tick launches every group's work, then copies each
group's partials to the host.  Lanes are independent, so no group waits on
another (the JAX runner's lane-sharded mesh, partitioned with no
collectives).

Thread-safe, two locks:

* ``_state_lock`` guards host bookkeeping: slot allocation, per-session
  feature buffers, the host mirror of (tokens, lengths, times).  Held only
  briefly; ``feed``'s buffer append and partial polls never wait on device
  work.
* ``_tick_lock`` serializes device work (ticks and slot resets).  The tick
  gathers chunks under the state lock, releases it for the device work and
  the fetch, then takes it again to publish the results.

Acquisition order is always ``_tick_lock`` then ``_state_lock``.

The persistent state is never written in place: a tick replaces it with
the encoder's and the decoder's outputs, and a slot reset builds new
tensors.  (``_zero_encoder_state`` gives an LSTM encoder one tensor as both
h and c, so an in-place reset of one would write both.)
"""

from __future__ import annotations

import copy
import threading
from typing import List, Optional

import numpy as np
import torch

from rnntransducer_tpu_torch.config import AudioConfig
from rnntransducer_tpu_torch.decode.beam_batched import (NEG, BeamCarry,
                                                         beam_decode_frames,
                                                         best_hyp_all,
                                                         init_beam_carry,
                                                         settle_word_lm)
from rnntransducer_tpu_torch.decode.greedy import (GreedyCarry, _device,
                                                   greedy_decode_frames,
                                                   init_greedy_carry)
from rnntransducer_tpu_torch.decode.streaming import (StreamingFrontend,
                                                      _zero_encoder_state,
                                                      check_chunk_frames)
from rnntransducer_tpu_torch.models.cells import RNNState
from rnntransducer_tpu_torch.models.transducer import RNNTransducer
from rnntransducer_tpu_torch.parallel.mesh import lane_devices
from rnntransducer_tpu_torch.utils.precision import (decode_dtype,
                                                     match_param_dtype,
                                                     param_dtype)


@torch.inference_mode()
def _batched_encode(model: RNNTransducer, feats, n_valid, enc_state):
    """The encoder over every lane: feats (S, chunk, mels), n_valid (S,)
    frames valid per lane (0 = idle).  Returns (enc, new_state); an idle
    lane's state comes back bit for bit.

    The recurrent encoder keeps a length-0 row's carry by itself.  The
    streaming Conformer does not: its cache always slides by one chunk and
    rebuilds the conv tail from the chunk (the JAX module alike), so an
    idle lane would lose a chunk of attention history and its conv tail.
    Its h and c are selected per lane by ``n_valid > 0`` here, which keeps
    ``ConformerEncoder`` identical to the JAX module."""
    enc, new_state = model.encode(match_param_dtype(model, feats), n_valid, enc_state)
    if model.cfg.transnet.arch == "conformer":
        live = (n_valid > 0)[None, None, :, None]           # lane axis 2
        new_state = RNNState(torch.where(live, new_state.h, enc_state.h),
                             torch.where(live, new_state.c, enc_state.c))
    return enc, new_state


@torch.inference_mode()
def _batched_chunk_step(model: RNNTransducer, feats, n_valid, enc_state,
                        carry: GreedyCarry, blank_id: int, max_symbols: int):
    """One tick: encode a chunk for every slot + advance the greedy carry."""
    enc, new_enc_state = _batched_encode(model, feats, n_valid, enc_state)
    n_enc = model.cfg.transnet.output_lengths(n_valid)
    return new_enc_state, greedy_decode_frames(model, enc, n_enc, carry,
                                               blank_id, max_symbols)


@torch.inference_mode()
def _batched_chunk_step_beam(model: RNNTransducer, feats, n_valid, enc_state,
                             carry: BeamCarry, blank_id: int, max_symbols: int,
                             lm_table=None, lm_weight=0.0, word_lm=None):
    enc, new_enc_state = _batched_encode(model, feats, n_valid, enc_state)
    n_enc = model.cfg.transnet.output_lengths(n_valid)
    return new_enc_state, beam_decode_frames(
        model, enc, n_enc, carry, blank_id, max_symbols, lm_table=lm_table,
        lm_weight=lm_weight, word_lm=word_lm)


def _put(x: Optional[torch.Tensor], index, value, dim: int = 0):
    """A new tensor: ``x`` with ``x[index]`` along ``dim`` set to ``value``."""
    if x is None:
        return None
    out = x.clone()
    out[(slice(None),) * dim + (index,)] = value
    return out


def _reset_enc_slot(enc_state: RNNState, slot: int) -> RNNState:
    """The encoder state with lane ``slot`` zeroed (lane axis 2), each of h
    and c from its own slice (the Conformer's differ in shape); they come
    back as tensors of their own."""
    return RNNState(_put(enc_state.h, slot, 0, 2), _put(enc_state.c, slot, 0, 2))


@torch.inference_mode()
def _reset_slot(model: RNNTransducer, enc_state: RNNState, carry: GreedyCarry,
                slot: int, blank_id: int):
    """(enc_state, carry) with one greedy lane re-initialized (lane axis 2 of
    recurrent states, 0 of the carry's other leaves)."""
    blank1 = torch.full((1,), blank_id, dtype=torch.int64, device=carry.tokens.device)
    dec_out0, state0 = model.predict_step(blank1, None)
    pstate = RNNState(_put(carry.state.h, slot, state0.h[:, :, 0], 2),
                      _put(carry.state.c, slot,
                           None if state0.c is None else state0.c[:, :, 0], 2))
    return _reset_enc_slot(enc_state, slot), GreedyCarry(
        dec_out=_put(carry.dec_out, slot, dec_out0[0]), state=pstate,
        last_appended=_put(carry.last_appended, slot, blank_id),
        tokens=_put(carry.tokens, slot, blank_id),
        lengths=_put(carry.lengths, slot, 0),
        times=_put(carry.times, slot, 0),
        frames_done=_put(carry.frames_done, slot, 0))


@torch.inference_mode()
def _reset_slot_beam(model: RNNTransducer, enc_state: RNNState, carry: BeamCarry,
                     slot: int, blank_id: int, word_lm_start: int = -1):
    """Re-initialize one beam lane: (S, K, ...) leaves at row ``slot``, the
    flat (S*K) rows [slot*K, (slot+1)*K) of dec_out and the prediction
    state."""
    K = carry.scores.shape[1]
    dev = carry.scores.device
    dec_out0, state0 = model.predict_step(
        torch.full((K,), blank_id, dtype=torch.int64, device=dev), None)
    flat = slice(slot * K, (slot + 1) * K)
    scores0 = torch.full((K,), NEG, dtype=carry.scores.dtype, device=dev)
    scores0[0] = 0.0
    pstate = RNNState(_put(carry.state.h, flat, state0.h, 2),
                      _put(carry.state.c, flat, state0.c, 2))
    return _reset_enc_slot(enc_state, slot), BeamCarry(
        scores=_put(carry.scores, slot, scores0),
        tokens=_put(carry.tokens, slot, blank_id),
        lens=_put(carry.lens, slot, 0),
        last=_put(carry.last, slot, blank_id),
        dec_out=_put(carry.dec_out, flat, dec_out0),
        state=pstate,
        # device char-LM history: blank = no history yet
        ctx=_put(carry.ctx, slot, blank_id),
        # device word-LM bookkeeping: the LM's <s> state, the trie root
        wlm_state=_put(carry.wlm_state, slot, word_lm_start),
        wlm_node=_put(carry.wlm_node, slot, 0))


class BatchedSession:
    """One lane of a :class:`BatchedStreamingRunner`.  API mirrors
    ``StreamingRecognizer``: feed / flush / tokens."""

    def __init__(self, runner: "BatchedStreamingRunner", slot: int,
                 frontend: StreamingFrontend):
        self._runner = runner
        self.slot = slot
        self.frontend = frontend
        self._feat_buf = np.zeros((0, frontend.cfg.n_mels), np.float32)
        self._emitted = 0
        self._closed = False
        self._final_times: List[float] = []  # captured at flush (slot reuse)

    # -- internal: one pending chunk (or final partial), None if not ready
    def _take_chunk(self, final: bool):
        cf = self._runner.chunk_frames
        if len(self._feat_buf) >= cf:
            chunk, self._feat_buf = self._feat_buf[:cf], self._feat_buf[cf:]
            return chunk, cf
        if final and len(self._feat_buf) > 0:
            n = len(self._feat_buf)
            chunk = np.zeros((cf, self._feat_buf.shape[1]), np.float32)
            chunk[:n] = self._feat_buf
            self._feat_buf = self._feat_buf[:0]
            return chunk, n
        return None

    def _new_tokens(self) -> List[int]:
        toks, total = self._runner.slot_tokens(self.slot)
        out = [int(t) for t in toks[self._emitted:total]]
        self._emitted = total
        return out

    def _append(self, feats: np.ndarray) -> None:
        if len(feats):
            with self._runner._state_lock:
                # under the state lock: another connection's drain() may be
                # gathering chunks (_take_chunk) from this session right now
                self._feat_buf = np.concatenate([self._feat_buf, feats])

    # ------------------------------------------------------------- public
    @property
    def decoder(self) -> str:
        return self._runner.decoder

    def feed(self, samples: np.ndarray, drain: bool = True) -> List[int]:
        """Feed PCM; returns newly emitted token ids (greedy; beam returns
        [] — poll ``.tokens`` for the ranked best, which can rewrite).
        drain=False only buffers: callers coordinating many sessions can
        feed them all first and then call ``runner.drain()`` once, so every
        lane fills in the same tick."""
        if self._closed:
            raise ValueError("session is closed")
        self._append(self.frontend.feed(samples))
        if not drain:
            return []
        self._runner.drain()
        if self._runner.decoder == "beam":
            return []
        return self._new_tokens()

    def flush(self) -> List[int]:
        """End of stream: drain trailing frames, free the slot, and return
        the remaining newly emitted tokens (beam: the final ranked best)."""
        if self._closed:
            return []
        self._append(self.frontend.flush())
        self._runner.drain(final_session=self)
        if self._runner.decoder == "beam":
            if self._runner._word_lm is not None:
                # word-LM lanes: the final ranked best is EOS-settled (the
                # in-progress word + </s> scored), one extra device call per
                # flush, never per tick
                out = self._runner.settled_slot_tokens(self.slot)
            else:
                out = self.tokens
        else:
            out = self._new_tokens()
            self._final_times = self.timestamps  # before the slot is reused
        self._runner._release(self)
        self._closed = True
        return out

    @property
    def tokens(self) -> List[int]:
        toks, total = self._runner.slot_tokens(self.slot)
        return [int(t) for t in toks[:total]]

    @property
    def timestamps(self) -> List[float]:
        """Per-token emission seconds, parallel to ``.tokens`` (greedy lanes
        only: beam hypotheses rewrite).  After ``flush()`` the values
        captured at stream end are served (the slot may be reused)."""
        if self._runner.decoder != "greedy" or self._runner.fused:
            raise ValueError("timestamps are available for greedy sessions")
        if self._closed:
            return list(self._final_times)
        times, total = self._runner.slot_times(self.slot)
        sec = self._runner.frame_sec
        return [float(t) * sec for t in times[:total]]

    def abort(self) -> None:
        """Free the slot without the final drain, for abnormal client
        termination (disconnect mid-stream, protocol error).  Idempotent; a
        session already flushed is a no-op.  Without it every abnormally
        ended connection would hold its slot until no session could open."""
        if self._closed:
            return
        self._closed = True
        with self._runner._state_lock:
            self._feat_buf = self._feat_buf[:0]
        self._runner._release(self)


class _LaneGroup:
    """One device's share of a runner's lanes: slots [lo, hi), with its own
    model, LM tables, encoder state and decode carry on ``device``."""

    def __init__(self, model: RNNTransducer, lo: int, hi: int, device_lm, word_lm):
        self.model = model
        self.device = _device(model)
        self.lo, self.hi = lo, hi
        self.lm_table = None if device_lm is None else device_lm.to(self.device).table
        self.word_lm = None if word_lm is None else word_lm.to(self.device)
        self.enc_state = _zero_encoder_state(model, hi - lo)
        self.carry = None  # the decoders' (none in the host fused mode)


class BatchedStreamingRunner:
    def __init__(self, model: RNNTransducer, audio_cfg: AudioConfig,
                 max_sessions: int = 8, chunk_frames: int = 64, blank_id: int = 0,
                 max_symbols: int = 3, max_output_len: int = 512,
                 decoder: str = "greedy", beam_width: int = 4, mesh=None,
                 lm=None, hotwords=None, hotword_weight=None, tokenizer=None,
                 improved: bool = True, state_beam: float = 4.6,
                 expand_beam: float = 2.3, device_lm=None,
                 precision: Optional[str] = None, word_lm=None):
        """The lanes live on the model's device; the model holds its own
        weights (the JAX runner takes ``(model, variables)``).

        ``mesh``: a list of devices (``parallel.mesh.lane_devices``) to
        shard the lanes over, the JAX runner's 1-D mesh.  Each device holds
        one lane group: a copy of the model (after the ``precision`` cast)
        and of the LM tables, and the state of ``max_sessions / n`` lanes;
        slot s belongs to group ``s // (max_sessions / n)``, the JAX
        runner's slot-major split.  A tick launches every group's device
        work, then copies each group's partials to the host.  The lanes
        must divide evenly; host LM / hotword fusion is not sharded.

        LM / hotword shallow fusion: ``lm`` (``decode.ngram_lm.NGramLM``)
        and / or ``hotwords`` with ``decoder="beam"`` and a ``tokenizer``.
        Each lane runs the host A/B search (``decode/beam.py``), and every
        lane's wave-scoring requests are batched into one device call per
        pump round (``decode_frames_multilane``); the tick encodes only.

        ``device_lm`` (``decode.device_lm.DeviceCharLM``, ``decoder="beam"``
        only): grapheme-level fusion inside the beam tick, the table on the
        device.  ``word_lm`` (``decode.device_word_lm.DeviceWordLM``,
        ``decoder="beam"`` only): word-boundary fusion inside the beam
        tick; ``flush()`` serves the EOS-settled ranked best.  Both exclude
        the host fused mode; they compose with each other and with a mesh.

        ``precision``: 'bf16' / 'fp32' decode with a cast copy of the model;
        None keeps the model's dtype."""
        tn = model.cfg.transnet
        if tn.bidirectional:
            raise ValueError("streaming requires a unidirectional encoder")
        stride = tn.time_reduction_stride
        check_chunk_frames(tn, chunk_frames)
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"unknown decoder: {decoder}")
        self.fused = lm is not None or bool(hotwords)
        if self.fused and decoder != "beam":
            raise ValueError("LM/hotword fusion requires decoder='beam'")
        for name, table in (("device_lm", device_lm), ("word_lm", word_lm)):
            if table is None:
                continue
            if decoder != "beam":
                raise ValueError(f"{name} requires decoder='beam'")
            if self.fused:
                raise ValueError(
                    f"{name} (on-device fusion) and lm/hotwords (host "
                    "word-level fusion) are mutually exclusive")
        if self.fused and mesh is not None:
            raise ValueError(
                "LM/hotword fusion + lane sharding is unsupported (the "
                "fused search is host-side; shard plain beam lanes instead)")
        devices = None if mesh is None else lane_devices(mesh)
        if devices is not None and max_sessions % len(devices):
            raise ValueError(
                f"max_sessions ({max_sessions}) must divide evenly across "
                f"the mesh ({len(devices)} devices)")
        if precision is not None and decode_dtype(precision) != param_dtype(model):
            model = copy.deepcopy(model).to(decode_dtype(precision))
        self.model = model
        self.audio_cfg = audio_cfg
        # encoder-frame duration in seconds (timestamps surface)
        self.frame_sec = stride * audio_cfg.window_stride_sec
        self.max_sessions = max_sessions
        self.chunk_frames = chunk_frames
        self.blank_id = blank_id
        self.max_symbols = max_symbols
        self.max_output_len = max_output_len
        self.decoder = decoder
        self.beam_width = beam_width
        # order: _tick_lock (device work) before _state_lock (bookkeeping)
        self._tick_lock = threading.RLock()
        self._state_lock = threading.RLock()
        self._free = list(range(max_sessions))
        self._live: dict = {}
        self._host_beam = None
        self._host_sessions: dict = {}
        self._word_lm = word_lm
        self._word_lm_start = -1 if word_lm is None else word_lm.start_state
        self._lm_weight = 0.0 if device_lm is None else device_lm.weight
        self._lanes = max_sessions // (1 if devices is None else len(devices))
        self._groups: List[_LaneGroup] = []
        for lo in range(0, max_sessions, self._lanes):
            m = model if devices is None else copy.deepcopy(model).to(
                devices[lo // self._lanes])
            self._groups.append(_LaneGroup(m, lo, lo + self._lanes, device_lm, word_lm))
        if self.fused:
            from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
            from rnntransducer_tpu_torch.decode.hotwords import DEFAULT_HOTWORD_WEIGHT
            self._host_beam = BeamSearchDecoder(
                model, blank_id=blank_id, tokenizer=tokenizer,
                beam_width=beam_width, improved=improved,
                state_beam=state_beam, expand_beam=expand_beam, lm=lm,
                hotwords=hotwords,
                hotword_weight=(DEFAULT_HOTWORD_WEIGHT if hotword_weight
                                is None else hotword_weight))
        elif decoder == "beam":
            for g in self._groups:
                g.carry = init_beam_carry(
                    g.model, self._lanes, beam_width, blank_id, max_output_len,
                    lm_context=device_lm.context if device_lm is not None else 0,
                    word_lm_start=self._word_lm_start)
        else:
            for g in self._groups:
                g.carry = init_greedy_carry(g.model, self._lanes, blank_id,
                                            max_output_len)
        # host mirror of (tokens, lengths[, times]), refreshed once per tick
        self._tokens = np.full((max_sessions, max_output_len), blank_id, np.int64)
        self._lengths = np.zeros((max_sessions,), np.int64)
        # per-token emission frames (greedy only; beam hypotheses rewrite)
        self._times = np.zeros((max_sessions, max_output_len), np.int64)

    def _group(self, slot: int) -> _LaneGroup:
        return self._groups[slot // self._lanes]

    def _only_group(self) -> _LaneGroup:
        if len(self._groups) != 1:
            raise ValueError("a sharded runner's state lives in its lane groups")
        return self._groups[0]

    # the state of an unsharded runner (``mesh=None``), for inspection
    @property
    def _enc_state(self) -> RNNState:
        return self._only_group().enc_state

    @_enc_state.setter
    def _enc_state(self, value: RNNState) -> None:
        self._only_group().enc_state = value

    @property
    def _carry(self):
        return self._only_group().carry

    @_carry.setter
    def _carry(self, value) -> None:
        self._only_group().carry = value

    # ------------------------------------------------------------ sessions
    def open(self, normalize: str = "none", norm_mean: float = 0.0,
             norm_var: float = 1.0) -> BatchedSession:
        # tick lock first: the reset replaces one lane of the persistent
        # state, which must not interleave with a tick in flight
        with self._tick_lock:
            with self._state_lock:
                if not self._free:
                    raise RuntimeError(
                        f"all {self.max_sessions} session slots in use")
                slot = self._free.pop()
            g = self._group(slot)
            if self.fused:
                g.enc_state = _reset_enc_slot(g.enc_state, slot - g.lo)
                self._host_sessions[slot] = self._host_beam.open_session()
            else:
                g.enc_state, g.carry = self._reset(g, g.enc_state, g.carry,
                                                   slot - g.lo)
            with self._state_lock:
                self._tokens[slot] = self.blank_id
                self._lengths[slot] = 0
                self._times[slot] = 0
                sess = BatchedSession(
                    self, slot, StreamingFrontend(self.audio_cfg, normalize,
                                                  norm_mean=norm_mean,
                                                  norm_var=norm_var))
                self._live[slot] = sess
                return sess

    def _reset(self, g: _LaneGroup, enc_state, carry, lane: int):
        """(enc_state, carry) of group ``g`` with its lane ``lane`` reset."""
        if self.decoder == "beam":
            return _reset_slot_beam(g.model, enc_state, carry, lane,
                                    self.blank_id, self._word_lm_start)
        return _reset_slot(g.model, enc_state, carry, lane, self.blank_id)

    def _release(self, sess: BatchedSession) -> None:
        with self._state_lock:
            self._live.pop(sess.slot, None)
            self._host_sessions.pop(sess.slot, None)
            self._free.append(sess.slot)

    def settled_slot_tokens(self, slot: int) -> List[int]:
        """One lane's best hypothesis under EOS word-LM settling
        (``settle_word_lm``), used by flush(); the carry itself is untouched,
        so other lanes' mid-stream ranking is unaffected."""
        with self._tick_lock:
            g = self._group(slot)
            t, n = best_hyp_all(settle_word_lm(g.carry, g.word_lm))
            return t[slot - g.lo, :int(n[slot - g.lo])].tolist()

    def slot_tokens(self, slot: int):
        with self._state_lock:
            # copy: callers iterate after the lock is released, and a
            # concurrent open() reusing the slot rewrites the live row
            return self._tokens[slot].copy(), int(self._lengths[slot])

    def slot_times(self, slot: int):
        """Per-token emission frames for a greedy slot (see GreedyCarry):
        absolute encoder-frame indices, parallel to slot_tokens."""
        if self.decoder != "greedy" or self.fused:
            raise ValueError("timestamps are available for greedy sessions")
        with self._state_lock:
            return self._times[slot].copy(), int(self._lengths[slot])

    # ------------------------------------------------------------- device
    def _idle_inputs(self, g: Optional[_LaneGroup] = None):
        """All-idle tick inputs of group ``g`` (the only group by default)."""
        g = g or self._only_group()
        feats = torch.zeros((g.hi - g.lo, self.chunk_frames, self.audio_cfg.n_mels),
                            dtype=torch.float32, device=g.device)
        return feats, torch.zeros((g.hi - g.lo,), dtype=torch.int64, device=g.device)

    def _step(self, feats, n_valid, g: Optional[_LaneGroup] = None):
        """One tick's device work against group ``g``'s live state (the only
        group by default): its (enc_state, carry)."""
        g = g or self._only_group()
        if self.decoder == "beam":
            return _batched_chunk_step_beam(
                g.model, feats, n_valid, g.enc_state, g.carry, self.blank_id,
                self.max_symbols, lm_table=g.lm_table, lm_weight=self._lm_weight,
                word_lm=g.word_lm)
        return _batched_chunk_step(g.model, feats, n_valid, g.enc_state, g.carry,
                                   self.blank_id, self.max_symbols)

    def _fetch(self, carry):
        """A group's partials in one device-to-host copy: (tokens (S, L),
        lengths (S,), times (S, L) or None).  Beam: the ranked best
        (length-normalized) of each lane, ranked on the device."""
        if self.decoder == "beam":
            t, n = best_hyp_all(carry)
            parts = [t, n[:, None]]
        else:
            parts = [carry.tokens, carry.lengths[:, None], carry.times]
        host = torch.cat(parts, dim=1).cpu().numpy()
        L = self.max_output_len
        return host[:, :L], host[:, L], (host[:, L + 1:] if len(parts) == 3 else None)

    def warmup(self) -> None:
        """Everything the first client would otherwise wait for, before
        serving traffic: build the encoder's recurrent kernel (an RNN
        encoder's), then run, in every lane group, one all-idle tick (every
        ``n_valid`` = 0), one slot reset and one partials fetch against the
        live state, discarding their results.  An all-idle tick changes no
        lane (asserted by tests), the reset builds new tensors, and the live
        state is left as it was."""
        tn = self.model.cfg.transnet
        if tn.arch == "rnn" and any(g.device.type == "cuda" for g in self._groups):
            from rnntransducer_tpu_torch.ops import build
            build.build_all([f"{tn.rnn_type.lower()}_fwd"])
        with self._tick_lock:
            if self.fused:
                # the encode-only tick + the two wave-scoring widths a fused
                # fleet hits first (one lane, the full-width pump)
                g = self._only_group()
                enc, _ = _batched_encode(g.model, *self._idle_inputs(g), g.enc_state)
                _reset_enc_slot(g.enc_state, 0)
                hb = self._host_beam
                sessions = [hb.open_session() for _ in range(self.max_sessions)]
                for n_lanes in sorted({1, self.max_sessions}):
                    hb._score_wave_multi([(list(s.B_hyps), enc[0, :1])
                                          for s in sessions[:n_lanes]])
                return
            for g in self._groups:
                enc_state, carry = self._step(*self._idle_inputs(g), g)
                self._fetch(carry)
                self._reset(g, enc_state, carry, 0)
                if g.word_lm is not None:
                    # flush()'s settled final ranking
                    best_hyp_all(settle_word_lm(carry, g.word_lm))[0].cpu()

    # ---------------------------------------------------------------- tick
    def drain(self, final_session: Optional[BatchedSession] = None) -> int:
        """Tick until no session has a full chunk pending (plus the final
        partial chunk of ``final_session``).  Returns the number of ticks."""
        ticks = 0
        with self._tick_lock:
            while True:
                with self._state_lock:
                    feats = np.zeros((self.max_sessions, self.chunk_frames,
                                      self.audio_cfg.n_mels), np.float32)
                    n_valid = np.zeros((self.max_sessions,), np.int64)
                    active: list = []  # (slot, frames) with work this tick
                    for slot, sess in self._live.items():
                        taken = sess._take_chunk(final=(sess is final_session))
                        if taken is not None:
                            feats[slot], n_valid[slot] = taken
                            active.append((slot, taken[1]))
                if not active:
                    break
                # device work and the fetch run WITHOUT the state lock: other
                # connections keep buffering audio and polling partials
                # while a wide tick is in flight
                ticks += 1
                if self.fused:
                    g = self._only_group()
                    self._tick_fused(torch.from_numpy(feats).to(g.device),
                                     torch.from_numpy(n_valid).to(g.device), active)
                    continue
                # every group's device work is queued before the first
                # fetch waits on its group
                steps = [self._step(torch.from_numpy(feats[g.lo:g.hi]).to(g.device),
                                    torch.from_numpy(n_valid[g.lo:g.hi]).to(g.device), g)
                         for g in self._groups]
                for g, (enc_state, carry) in zip(self._groups, steps):
                    g.enc_state, g.carry = enc_state, carry
                # one device-to-host copy per group, in slot order
                parts = [self._fetch(g.carry) for g in self._groups]
                t, n = (np.concatenate([p[i] for p in parts]) for i in (0, 1))
                tm = None if parts[0][2] is None else np.concatenate([p[2] for p in parts])
                with self._state_lock:
                    self._tokens, self._lengths = t, n
                    if tm is not None:
                        self._times = tm
            if (self.fused and final_session is not None
                    and final_session.slot in self._host_sessions):
                # settle the ending lane's EOS LM scoring once; flush() then
                # serves the final ranked best from the mirror
                best = self._host_beam.finalize(
                    self._host_sessions[final_session.slot])[0]
                self._publish_fused(final_session.slot, best)
        return ticks

    def _tick_fused(self, feats, n_valid, active) -> None:
        """One fused-mode tick: the batched encode on the device, then every
        active lane's host A/B search advances together with cross-lane wave
        batching (one device call per pump round).  Each lane's valid frames
        stay on the device."""
        g = self._only_group()
        enc, g.enc_state = _batched_encode(g.model, feats, n_valid, g.enc_state)
        red = self.model.cfg.transnet.output_lengths
        with self._state_lock:
            lanes = [(slot, self._host_sessions[slot]) for slot, _ in active
                     if slot in self._host_sessions]
        frames = dict(active)
        self._host_beam.decode_frames_multilane(
            [(hs, enc[slot, :red(frames[slot])]) for slot, hs in lanes])
        for slot, hs in lanes:
            self._publish_fused(slot, self._host_beam.current_best(hs))

    def _publish_fused(self, slot: int, tokens) -> None:
        n = min(len(tokens), self.max_output_len)
        with self._state_lock:
            self._tokens[slot, :n] = tokens[:n]
            self._lengths[slot] = n
