"""Deployment bundles (port of ``rnntransducer_tpu/utils/export.py``):
transcription programs saved by ``torch.export``.

A trained model exports to a **self-contained bundle**: one program per
shape bucket (``{decoder}_b{batch}_t{frames}.pt2``, the params inside it)
plus the vocab and a manifest (``bundle.json``, the JAX package's keys and
``format_version``).  Loading a bundle needs torch, this package's op
registrations and tokenizer, and the bundle directory: no model is built
and no config or checkpoint is read.

* One program per (batch, frames) bucket; the loader pads into the smallest
  covering bucket.
* One program serves the CPU and the card.  The JAX package exports
  portable scans because a Pallas kernel would pin its artifact to one TPU
  generation.  Here the recurrent layers trace to the registered ops
  (``ops/library.py``: ``gru_scan`` / ``lstm_scan`` nodes), which resolve by
  the tensors' device when the program runs: the plain versions on the CPU,
  the kernels K1 / K3 on the card.  The program is traced on the CPU and
  moved to the card when it is loaded (``move_to_device_pass``).
* The decoders' frame loops run in one ``while_loop`` over frames around the
  same functional frame step the eager decoders loop over
  (``decode/greedy.greedy_frame_step``, ``decode/beam_batched.beam_frame_step``),
  where the JAX package runs one ``lax.scan``; frames past the longest
  utterance change nothing and are not run.
* ``input_kind="wav"`` bakes the plain log-mel frontend
  (``frontend/melspec.LogMelFrontend``) into the program, as the JAX
  package bakes its plain ``LogMelFrontend``; ``"logmel"`` exports from
  precomputed features.
* ``streaming_chunk_frames=N`` adds a chunk program (unidirectional
  encoders only) whose carry, the encoder state and the greedy carry, is a
  flat tuple of tensors that the loader threads through unread.

    python -m rnntransducer_tpu_torch.utils.export --checkpoint_dir ckpt \\
        --out_dir bundle --batch 8 --frame_buckets 512
    ExportedTranscriber("bundle").transcribe_batch(waves)   # on the card
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

import rnntransducer_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)
from rnntransducer_tpu_torch.config import AudioConfig, Config
from rnntransducer_tpu_torch.decode.beam_batched import (_rank_scores, beam_carry,
                                                         beam_frame_step)
from rnntransducer_tpu_torch.decode.greedy import greedy_carry, greedy_frame_step
from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer, compose_jamo
from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.precision import match_param_dtype

BUNDLE_MANIFEST = "bundle.json"
_FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


def _program_name(decoder: str, batch: int, frames: int) -> str:
    return f"{decoder}_b{batch}_t{frames}.pt2"


def _tensor_leaves(tree):
    """(the tensors of ``tree`` in pytree order, what :func:`_rebuild`
    needs to put new ones in their places)."""
    leaves, spec = tree_flatten(tree)
    where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    return [leaves[i] for i in where], (spec, leaves, where)


def _rebuild(tensors, layout):
    spec, leaves, where = layout
    leaves = list(leaves)
    for i, t in zip(where, tensors):
        leaves[i] = t
    return tree_unflatten(leaves, spec)


def frames_while_loop(step, carry, enc: torch.Tensor, enc_lengths: torch.Tensor):
    """``carry`` after ``step(carry, enc_t, t)`` over the frames t = 0 ..
    max(enc_lengths) - 1 of enc (B, T, De), as one ``while_loop`` (t a
    0-dim int64 tensor): the traced form of the eager decoders' frame
    loops.  The frames it does not run are past every utterance's length,
    where a step changes nothing."""
    from torch._higher_order_ops import while_loop

    flat, layout = _tensor_leaves(carry)
    # the loop's carried inputs must not alias one another
    flat = [x.clone() for x in flat]
    limit = enc_lengths.to(torch.int64).max().clamp(max=enc.shape[1])

    def cond(t, *_):
        return t < limit

    def body(t, *flat_c):
        enc_t = enc.index_select(1, t.reshape(1))[:, 0]
        new, _ = _tensor_leaves(step(_rebuild(flat_c, layout), enc_t, t))
        # nor may an output be one of the inputs (a field the step keeps)
        return (t + 1, *(x.clone() if any(x is c for c in flat_c) else x
                         for x in new))

    out = while_loop(cond, body, (limit.new_zeros(()), *flat))
    return _rebuild(out[1:], layout)


class _Transcribe(torch.nn.Module):
    """(wav (B, S) f32, wav_lengths (B,) i32) or (feats (B, T, n_mels) f32,
    feat_lengths) -> (tokens (B, max_output_len) i64 blank-padded, lengths
    (B,) i64): greedy, or the device beam's top-1."""

    def __init__(self, model, audio: Optional[AudioConfig], decoder: str, blank: int,
                 beam_width: int, max_symbols: int, max_output_len: int):
        super().__init__()
        self.model = model
        self.frontend = LogMelFrontend(audio) if audio is not None else None
        self.decoder, self.blank, self.beam_width = decoder, blank, beam_width
        self.max_symbols, self.max_output_len = max_symbols, max_output_len

    def forward(self, inputs, lengths):
        model, blank, syms = self.model, self.blank, self.max_symbols
        if self.frontend is not None:
            inputs, lengths = self.frontend(inputs, lengths)
        enc, _ = model.encode(match_param_dtype(model, inputs), lengths)
        enc_lengths = model.cfg.transnet.output_lengths(lengths.to(torch.int64))
        B = inputs.shape[0]
        if self.decoder == "beam":
            carry = frames_while_loop(
                lambda c, e, t: beam_frame_step(model, c, e, t < enc_lengths, blank,
                                                syms),
                beam_carry(model, B, self.beam_width, blank, self.max_output_len),
                enc, enc_lengths)
            # rank_beam's first column: the best by score / (len + 1)
            rank = _rank_scores(carry.scores, carry.lens, True, None)
            best = torch.argsort(-rank, dim=1, stable=True)[:, :1]
            toks = torch.gather(carry.tokens, 1, best[..., None].expand(
                B, 1, carry.tokens.shape[2]))[:, 0]
            return toks, torch.gather(carry.lens, 1, best)[:, 0]
        carry = frames_while_loop(
            lambda c, e, t: greedy_frame_step(model, c, e, t, enc_lengths, blank, syms),
            greedy_carry(model, B, blank, self.max_output_len), enc, enc_lengths)
        return carry.tokens, carry.lengths


class _StreamStep(torch.nn.Module):
    """(chunk (1, N, n_mels) f32, n_valid (1,) i32, carry) -> (tokens,
    lengths, carry'): one chunk through the encoder from its carried state,
    then the greedy frame loop resumed; ``carry`` is the flat tuple of the
    (encoder state, greedy carry) tensors."""

    def __init__(self, model, layout, blank: int, max_symbols: int):
        super().__init__()
        self.model, self.layout = model, layout
        self.blank, self.max_symbols = blank, max_symbols

    def forward(self, chunk, n_valid, carry):
        model = self.model
        enc_state, g = _rebuild(carry, self.layout)
        enc, enc_state = model.encode(match_param_dtype(model, chunk), n_valid, enc_state)
        n_enc = model.cfg.transnet.output_lengths(n_valid.to(torch.int64))
        g = frames_while_loop(
            lambda c, e, t: greedy_frame_step(model, c, e, t, n_enc, self.blank,
                                              self.max_symbols), g, enc, n_enc)
        g = g._replace(frames_done=g.frames_done + n_enc)
        return g.tokens, g.lengths, tuple(_tensor_leaves((enc_state, g))[0])


def _save_program(module, args, path: str) -> None:
    with torch.no_grad():
        program = torch.export.export(module, args)
    torch.export.save(program, path)


def export_transcriber(cfg: Config, params_or_state_dict: Mapping, out_dir: str, *,
                       tokenizer: Optional[GraphemeTokenizer] = None,
                       batch: int = 1,
                       frame_buckets: Sequence[int] = (256, 512, 1024),
                       input_kind: str = "wav",
                       decoder: str = "greedy",
                       beam_width: int = 4,
                       platforms: Sequence[str] = PLATFORMS,
                       max_symbols: int = 3,
                       max_output_len: int = 256,
                       streaming_chunk_frames: Optional[int] = None) -> str:
    """Export transcription programs for every frame bucket into
    ``out_dir`` (created).  Returns ``out_dir``.

    ``params_or_state_dict``: the JAX package's flax params tree or the
    port's state_dict.  Each program maps ``(wav (B,S) f32, wav_lengths (B,)
    i32)`` (or ``(feats (B,T,n_mels) f32, feat_lengths)`` for
    ``input_kind="logmel"``) to ``(tokens (B, max_output_len) i64
    blank-padded, lengths (B,) i64)``.  ``decoder="beam"`` bakes the device
    beam (``decode/beam_batched.py``, width ``beam_width``,
    length-normalized) and emits its best hypothesis: the same interface as
    greedy.  ``platforms``: the devices the loader may run the programs on,
    of ``("cpu", "cuda")``; the programs are traced on the CPU in float32.

    ``streaming_chunk_frames=N`` also exports a chunk program
    (unidirectional encoders only): greedy decoding resumed across N-frame
    feature chunks with the recurrent state as an explicit flat carry, which
    ``ExportedStreamingSession`` threads through unread."""
    from rnntransducer_tpu_torch.decode.streaming import _zero_encoder_state
    from rnntransducer_tpu_torch.models.transducer import build_model
    from rnntransducer_tpu_torch.serve import _is_flax_tree
    from rnntransducer_tpu_torch.utils import weights

    if input_kind not in ("wav", "logmel"):
        raise ValueError(f"input_kind must be 'wav' or 'logmel', got {input_kind!r}")
    if decoder not in ("greedy", "beam"):
        raise ValueError(f"decoder must be 'greedy' or 'beam', got {decoder!r}")
    bad = sorted(set(platforms) - set(PLATFORMS))
    if bad:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {bad}")
    stride = cfg.model.transnet.time_reduction_stride
    if streaming_chunk_frames:
        if cfg.model.transnet.bidirectional:
            raise ValueError("streaming export requires a unidirectional "
                             "encoder (transnet.bidirectional=false)")
        if stride > 1 and int(streaming_chunk_frames) % stride:
            raise ValueError(
                f"streaming_chunk_frames ({streaming_chunk_frames}) must be a "
                f"multiple of time_reduction_stride ({stride})")
    sd = params_or_state_dict
    if _is_flax_tree(sd):
        sd = weights.state_dict_from_flax(sd, cfg.model)
    model = build_model(cfg, "cpu", state_dict=sd).float()
    blank = cfg.data.text.pad_token_id
    hop = cfg.data.audio.hop_length
    n_mels = cfg.data.audio.n_mels
    os.makedirs(out_dir, exist_ok=True)

    module = _Transcribe(model, cfg.data.audio if input_kind == "wav" else None,
                         decoder, blank, beam_width, max_symbols, max_output_len)
    programs = []
    for frames in sorted(set(int(t) for t in frame_buckets)):
        if input_kind == "wav":
            # the full sample range of the bucket: num_frames = S//hop + 1,
            # so frames admits S up to frames*hop - 1
            x = torch.zeros((batch, frames * hop - 1), dtype=torch.float32)
        else:
            x = torch.zeros((batch, frames, n_mels), dtype=torch.float32)
        lengths = torch.full((batch,), x.shape[1], dtype=torch.int32)
        name = _program_name(decoder, batch, frames)
        _save_program(module, (x, lengths), os.path.join(out_dir, name))
        programs.append({"frames": frames, "file": name})

    streaming_meta = None
    if streaming_chunk_frames:
        n = int(streaming_chunk_frames)
        with torch.no_grad():
            carry0 = (_zero_encoder_state(model, 1),
                      greedy_carry(model, 1, blank, max_output_len))
        flat0, layout = _tensor_leaves(carry0)
        flat0 = [x.clone() for x in flat0]
        sfile = f"stream_greedy_t{n}.pt2"
        _save_program(_StreamStep(model, layout, blank, max_symbols),
                      (torch.zeros((1, n, n_mels), dtype=torch.float32),
                       torch.full((1,), n, dtype=torch.int32), tuple(flat0)),
                      os.path.join(out_dir, sfile))
        np.savez(os.path.join(out_dir, "stream_init.npz"),
                 **{f"c{i}": x.numpy() for i, x in enumerate(flat0)})
        streaming_meta = {
            "chunk_frames": n, "file": sfile, "init": "stream_init.npz",
            "n_carry": len(flat0), "max_output_len": max_output_len,
        }

    tok = tokenizer or GraphemeTokenizer.default(cfg.model.jointnet.num_classes)
    tok.save(os.path.join(out_dir, "vocab.json"))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "input_kind": input_kind,
        "batch": batch,
        "programs": programs,
        "platforms": list(platforms),
        "sample_rate": cfg.data.audio.sample_rate,
        "hop_length": hop,
        "n_mels": n_mels,
        "blank_id": blank,
        "max_output_len": max_output_len,
        "max_symbols": max_symbols,
        "decoder": decoder,
        "beam_width": beam_width if decoder == "beam" else None,
        "streaming": streaming_meta,
        "audio": dataclasses.asdict(cfg.data.audio),
    }
    with open(os.path.join(out_dir, BUNDLE_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def export_transcriber_from_checkpoint(checkpoint_dir: str, out_dir: str,
                                       step: Optional[int] = None,
                                       vocab_path: Optional[str] = None,
                                       **kw) -> str:
    """Bundle-export straight from a Trainer's checkpoint directory: the
    best-by-val_cer (else latest) step, or ``step`` (the counterpart of
    ``serve.Recognizer.from_checkpoint``)."""
    from rnntransducer_tpu_torch.tokenizer import load_tokenizer
    from rnntransducer_tpu_torch.train.checkpoint import (load_config,
                                                          load_decode_params)

    cfg = load_config(checkpoint_dir)
    params, _ = load_decode_params(checkpoint_dir, cfg, step=step)
    tokenizer = load_tokenizer(vocab_path or cfg.vocab_path,
                               cfg.model.jointnet.num_classes)
    return export_transcriber(cfg, params, out_dir, tokenizer=tokenizer, **kw)


def _read_manifest(bundle_dir: str) -> dict:
    with open(os.path.join(bundle_dir, BUNDLE_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported bundle format {manifest.get('format_version')}")
    files = [p["file"] for p in manifest.get("programs", [])]
    if manifest.get("streaming"):
        files.append(manifest["streaming"]["file"])
    foreign = [f for f in files if not f.endswith(".pt2")]
    if foreign:
        raise ValueError(
            f"bundle programs {foreign} are not torch.export programs (.pt2): "
            "a bundle of jax.export programs (.jaxexp) runs under the JAX "
            "package; export the model with this package instead")
    return manifest


def _load_program(path: str, device: torch.device, platforms: Sequence[str]):
    """The program at ``path`` as a callable on ``device``; raises where the
    bundle was not exported for that device."""
    if device.type not in platforms:
        raise ValueError(f"the bundle was exported for {list(platforms)}, not "
                         f"{device.type}")
    program = torch.export.load(path)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    return program.module()


class ExportedTranscriber:
    """Run a bundle written by :func:`export_transcriber` on ``device``
    (default the card; ``device="cpu"`` runs the plain versions).

    Needs torch, this package's op registrations and tokenizer and the
    bundle directory: no model, no config, no checkpoint.  Picks the
    smallest bucket covering each input, pads, runs the program, and
    decodes token ids to text with the bundled vocab."""

    def __init__(self, bundle_dir: str, device=None):
        self.manifest = _read_manifest(bundle_dir)
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"the bundle was exported for "
                             f"{self.manifest['platforms']}, not {self.device.type}")
        self.dir = bundle_dir
        self.tokenizer = GraphemeTokenizer.from_file(
            os.path.join(bundle_dir, "vocab.json"))
        self._programs = {}  # frames -> callable (loaded at first use)

    @property
    def batch(self) -> int:
        return int(self.manifest["batch"])

    def _bucket_for(self, frames_needed: int) -> int:
        buckets = sorted(p["frames"] for p in self.manifest["programs"])
        for b in buckets:
            if frames_needed <= b:
                return b
        raise ValueError(
            f"input needs {frames_needed} frames; largest exported bucket "
            f"is {buckets[-1]} (re-export with a bigger frame bucket)")

    def _program(self, frames: int):
        if frames not in self._programs:
            name = _program_name(self.manifest.get("decoder", "greedy"),
                                 self.batch, frames)
            self._programs[frames] = _load_program(
                os.path.join(self.dir, name), self.device, self.manifest["platforms"])
        return self._programs[frames]

    def _frames_of(self, inputs) -> int:
        if self.manifest["input_kind"] == "wav":
            return inputs.shape[1] // self.manifest["hop_length"] + 1
        return inputs.shape[1]

    def transcribe_tokens(self, inputs, lengths) -> Tuple[np.ndarray, np.ndarray]:
        """Raw program call: blank-padded token ids + counts for a full
        batch already padded to an exported bucket shape."""
        fn = self._program(self._frames_of(inputs))
        x = torch.as_tensor(np.asarray(inputs, np.float32)).to(self.device)
        n = torch.as_tensor(np.asarray(lengths, np.int32)).to(self.device)
        with torch.no_grad():
            toks, count = fn(x, n)
        return toks.cpu().numpy(), count.cpu().numpy()

    def transcribe_batch(self, wavs: Sequence[np.ndarray],
                         compose_hangul: bool = True) -> list:
        """wavs: float32 PCM arrays at the bundle's sample rate (or feature
        matrices (T, n_mels) for logmel bundles).  Any count: processed in
        bundle-batch groups.  Returns transcripts."""
        kind = self.manifest["input_kind"]
        hop = self.manifest["hop_length"]
        out = []
        B = self.batch
        for g in range(0, len(wavs), B):
            group = [np.asarray(w) for w in wavs[g:g + B]]
            lens = [len(w) if kind == "wav" else w.shape[0] for w in group]
            if kind == "wav":
                frames = self._bucket_for(max(lens) // hop + 1)
                width = frames * hop - 1  # matches the exported shape
                batch = np.zeros((B, width), np.float32)
                for i, w in enumerate(group):
                    batch[i, :min(len(w), width)] = w[:width]
                lengths = np.asarray(
                    [min(n, width) for n in lens] + [1] * (B - len(group)), np.int32)
            else:
                frames = self._bucket_for(max(lens))
                batch = np.zeros((B, frames, self.manifest["n_mels"]), np.float32)
                for i, w in enumerate(group):
                    batch[i, :min(w.shape[0], frames)] = w[:frames]
                lengths = np.asarray(
                    [min(n, frames) for n in lens] + [1] * (B - len(group)), np.int32)
            toks, n = self.transcribe_tokens(batch, lengths)
            for i in range(len(group)):
                ids = toks[i, :n[i]].tolist()
                text = self.tokenizer.decode(ids, group_tokens=False)
                out.append(compose_jamo(text) if compose_hangul else text)
        return out

    def transcribe(self, wav: np.ndarray, **kw) -> str:
        return self.transcribe_batch([wav], **kw)[0]


class ExportedStreamingSession:
    """Streaming recognition from a bundle exported with
    ``streaming_chunk_frames``: raw PCM in, incremental token ids out, on
    ``device`` (default the card).

    The recurrent carry crosses chunks as an opaque flat list of tensors
    (the flattened (encoder RNNState, GreedyCarry)), so no model is built;
    the log-mel / normalisation frontend runs on the host
    (``decode/streaming.StreamingFrontend``, numpy only)."""

    def __init__(self, bundle_dir: str, normalize: str = "none",
                 norm_mean: float = 0.0, norm_var: float = 1.0, device=None):
        from rnntransducer_tpu_torch.decode.streaming import StreamingFrontend

        self.manifest = _read_manifest(bundle_dir)
        sm = self.manifest.get("streaming")
        if not sm:
            raise ValueError(
                "bundle has no streaming program (re-export with "
                "streaming_chunk_frames=N)")
        self.device = resolve_device(device)
        self.chunk_frames = int(sm["chunk_frames"])
        self.tokenizer = GraphemeTokenizer.from_file(
            os.path.join(bundle_dir, "vocab.json"))
        audio = AudioConfig(**self.manifest["audio"])
        self.frontend = StreamingFrontend(audio, normalize, norm_mean=norm_mean,
                                          norm_var=norm_var)
        self._step = _load_program(os.path.join(bundle_dir, sm["file"]),
                                   self.device, self.manifest["platforms"])
        init = np.load(os.path.join(bundle_dir, sm["init"]))
        self._carry = tuple(torch.from_numpy(init[f"c{i}"]).to(self.device)
                            for i in range(int(sm["n_carry"])))
        self._feat_buf = np.zeros((0, audio.n_mels), np.float32)
        self._tokens: list = []
        self._n_mels = audio.n_mels

    def _run(self, final: bool) -> list:
        new = []
        n = self.chunk_frames
        while len(self._feat_buf) >= n or (final and len(self._feat_buf) > 0):
            valid = min(len(self._feat_buf), n)
            chunk = np.zeros((1, n, self._n_mels), np.float32)
            chunk[0, :valid] = self._feat_buf[:valid]
            self._feat_buf = self._feat_buf[valid:]
            with torch.no_grad():
                tokens, lengths, self._carry = self._step(
                    torch.from_numpy(chunk).to(self.device),
                    torch.tensor([valid], dtype=torch.int32, device=self.device),
                    self._carry)
            emitted = tokens[0, :int(lengths[0])].tolist()
            new.extend(emitted[len(self._tokens):])
            self._tokens = emitted
        return new

    def feed(self, samples: np.ndarray) -> list:
        """Feed PCM; returns NEWLY emitted token ids (monotone)."""
        feats = self.frontend.feed(np.asarray(samples, np.float32))
        if len(feats):
            self._feat_buf = np.concatenate([self._feat_buf, feats])
        return self._run(final=False)

    def flush(self) -> list:
        tail = self.frontend.flush()
        if len(tail):
            self._feat_buf = np.concatenate([self._feat_buf, tail])
        return self._run(final=True)

    @property
    def tokens(self) -> list:
        return list(self._tokens)

    def text(self, compose_hangul: bool = True) -> str:
        t = self.tokenizer.decode(self._tokens, group_tokens=False)
        return compose_jamo(t) if compose_hangul else t


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a trained checkpoint as a self-contained "
                    "torch.export deployment bundle (transcription programs "
                    "+ vocab).")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frame_buckets", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--input_kind", choices=["wav", "logmel"], default="wav")
    ap.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    ap.add_argument("--beam_width", type=int, default=4)
    ap.add_argument("--streaming_chunk_frames", type=int, default=None,
                    help="also export a chunked streaming greedy program "
                         "(unidirectional encoders only)")
    ap.add_argument("--platforms", nargs="+", default=list(PLATFORMS),
                    choices=list(PLATFORMS))
    ap.add_argument("--max_output_len", type=int, default=256)
    ap.add_argument("--vocab_path", default=None)
    args = ap.parse_args(argv)
    out = export_transcriber_from_checkpoint(
        args.checkpoint_dir, args.out_dir, step=args.step,
        vocab_path=args.vocab_path, batch=args.batch,
        frame_buckets=tuple(args.frame_buckets), input_kind=args.input_kind,
        decoder=args.decoder, beam_width=args.beam_width,
        streaming_chunk_frames=args.streaming_chunk_frames,
        platforms=tuple(args.platforms), max_output_len=args.max_output_len)
    print(f"exported bundle: {out}")


if __name__ == "__main__":
    main()
