"""Recognition API for serving (port of ``rnntransducer_tpu/serve.py``).

    rec = Recognizer.from_torch_params("bundle")        # config.json + params.pt
    rec = Recognizer.from_params("export")              # a params bundle
    rec = Recognizer.from_checkpoint("checkpoints")     # a Trainer's checkpoints
    text = rec.transcribe("utt.wav")
    texts = rec.transcribe_batch([wav1, wav2])          # batched device beam
    session = rec.stream()                              # StreamingRecognizer

Decoders: ``"beam_batched"`` (the default, the device beam at
``cfg.inference.beam_width``, with an optional on-device char LM),
``"greedy"``, and LM / hotword fusion through the host A/B beam
(``decode/beam.py``).

Deployment artifacts: ``export_params`` writes a params bundle (no
optimizer moments) in the JAX package's files, ``params.msgpack`` (flax's
``to_bytes`` layout of the flax params tree) + ``config.json`` +
``export.json``; ``Recognizer.from_params`` reads one, whichever package
wrote it.
"""

from __future__ import annotations

import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rnntransducer_tpu_torch.config import Config
from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
from rnntransducer_tpu_torch.decode.greedy import (greedy_decode,
                                                   greedy_decode_with_times)
from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
from rnntransducer_tpu_torch.models.transducer import build_model
from rnntransducer_tpu_torch.tokenizer import compose_jamo, load_tokenizer
from rnntransducer_tpu_torch.utils import weights
from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.precision import decode_dtype


def _is_flax_tree(params: Mapping) -> bool:
    return any(isinstance(v, Mapping) for v in params.values())


PARAMS_FILE = "params.msgpack"


def export_params(checkpoint_dir: str, out_dir: str,
                  step: Optional[int] = None) -> str:
    """Write a params bundle of a Trainer's checkpoint (the best-by-val_cer,
    else latest step, or ``step``): ``params.msgpack`` (the flax params tree
    in flax's ``to_bytes`` layout, :mod:`utils.flax_msgpack`),
    ``config.json`` and ``export.json`` holding ``{"step": n}``, the JAX
    package's ``serve.export_params`` files.  Returns ``out_dir``."""
    from rnntransducer_tpu_torch.train.checkpoint import (CheckpointManager,
                                                          load_config,
                                                          load_decode_params)
    from rnntransducer_tpu_torch.utils import flax_msgpack

    cfg = load_config(checkpoint_dir)
    if step is None:
        mgr = CheckpointManager(checkpoint_dir, save_top_k=cfg.train.save_top_k)
        step = mgr.best_or_latest_step()
        mgr.close()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    params, _ = load_decode_params(checkpoint_dir, cfg, step=step)
    tree = weights.flax_from_state_dict(params, cfg.model)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, PARAMS_FILE), "wb") as f:
        f.write(flax_msgpack.dumps(tree))
    cfg.to_json(os.path.join(out_dir, "config.json"))
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump({"step": int(step)}, f)
    return out_dir


class Recognizer:
    def __init__(self, cfg: Config, state_dict_or_params: Mapping, tokenizer,
                 decoder: str = "beam_batched", beam_width: Optional[int] = None,
                 max_output_len: int = 512, compose_hangul: bool = True,
                 lm_path: Optional[str] = None, lm_weight: Optional[float] = None,
                 hotwords: Optional[Sequence[str]] = None,
                 hotword_weight: Optional[float] = None,
                 device_lm_path: Optional[str] = None,
                 device_lm_weight: float = 0.3,
                 device_lm_order: Optional[int] = 3,
                 precision: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        sd = state_dict_or_params
        if _is_flax_tree(sd):
            sd = weights.state_dict_from_flax(sd, cfg.model)
        self.model = build_model(cfg, self.device, state_dict=sd)
        # precision: cast the float params once; activations follow them
        # (the decoders cast the features to the params' dtype); beam scores
        # stay fp32
        if precision is not None:
            self.model.to(decode_dtype(precision))
        self.tokenizer = tokenizer
        self.decoder = decoder
        # the default comes from the config persisted with the checkpoint
        self.beam_width = (beam_width if beam_width is not None
                           else cfg.inference.beam_width)
        self.max_output_len = max_output_len
        self.compose_hangul = compose_hangul
        self.frontend = LogMelFrontend(cfg.data.audio)
        # LM / hotword shallow fusion: fused decodes (and streams) route
        # through the host A/B beam (decode/beam.py)
        self.lm = None
        if lm_path:
            from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
            self.lm = NGramLM.load(lm_path, weight=lm_weight)
        self.hotwords = list(hotwords) if hotwords else None
        self.hotword_weight = hotword_weight
        if self.fused and decoder == "greedy":
            raise ValueError("LM/hotword fusion requires a beam decoder")
        # device char-LM fusion (decode/device_lm.py): the table lives on the
        # card and is gathered inside the device beam's frame loop
        self.device_lm = None
        if device_lm_path:
            if decoder == "greedy":
                raise ValueError("device_lm requires a beam decoder")
            if self.fused:
                raise ValueError(
                    "device_lm (on-device char fusion) and lm_path/hotwords "
                    "(host word-level fusion) are mutually exclusive")
            from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
            self.device_lm = DeviceCharLM.load(
                device_lm_path, tokenizer, weight=device_lm_weight,
                max_order=device_lm_order).to(self.device)

    @property
    def fused(self) -> bool:
        return self.lm is not None or bool(self.hotwords)

    # -- constructors --------------------------------------------------
    @classmethod
    def from_flax_params(cls, cfg: Config, params: Mapping, tokenizer=None,
                         vocab_path: Optional[str] = None, **kw) -> "Recognizer":
        """From the JAX package's params tree (nested dicts of numpy arrays)."""
        if tokenizer is None:
            tokenizer = load_tokenizer(vocab_path or cfg.vocab_path,
                                       cfg.model.jointnet.num_classes)
        return cls(cfg, weights.state_dict_from_flax(params, cfg.model),
                   tokenizer, **kw)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, step: Optional[int] = None,
                        vocab_path: Optional[str] = None,
                        average_k: Optional[int] = None, use_ema: bool = False,
                        **kw) -> "Recognizer":
        """From a Trainer's checkpoint directory: the best-by-val_cer (else
        latest) step, or ``step``; ``average_k``: the element-wise mean of the
        best k checkpoints' params; ``use_ema``: the EMA shadow of the run
        (``train.ema_decay > 0``)."""
        from rnntransducer_tpu_torch.train.checkpoint import (load_config,
                                                              load_decode_params)

        cfg = load_config(checkpoint_dir)
        params, _ = load_decode_params(checkpoint_dir, cfg, step=step,
                                       average_k=average_k, use_ema=use_ema)
        tokenizer = load_tokenizer(vocab_path or cfg.vocab_path,
                                   cfg.model.jointnet.num_classes)
        return cls(cfg, params, tokenizer, **kw)

    @classmethod
    def from_params(cls, export_dir: str, vocab_path: Optional[str] = None,
                    **kw) -> "Recognizer":
        """From a params bundle (:func:`export_params`, or the JAX package's
        ``serve.export_params``): ``config.json`` + ``params.msgpack``."""
        from rnntransducer_tpu_torch.utils import flax_msgpack

        cfg = Config.from_json(os.path.join(export_dir, "config.json"))
        with open(os.path.join(export_dir, PARAMS_FILE), "rb") as f:
            params = flax_msgpack.loads(f.read())
        tokenizer = load_tokenizer(vocab_path or cfg.vocab_path,
                                   cfg.model.jointnet.num_classes)
        return cls(cfg, params, tokenizer, **kw)

    @classmethod
    def from_torch_params(cls, directory: str, vocab_path: Optional[str] = None,
                          **kw) -> "Recognizer":
        """From a bundle written by ``utils.weights.save``."""
        cfg, sd = weights.load(directory)
        tokenizer = load_tokenizer(vocab_path or cfg.vocab_path,
                                   cfg.model.jointnet.num_classes)
        return cls(cfg, sd, tokenizer, **kw)

    # -- inference ------------------------------------------------------
    def _to_wave(self, w: Union[str, np.ndarray]) -> np.ndarray:
        if isinstance(w, str):
            from rnntransducer_tpu_torch.utils.audio_io import read_wav
            return read_wav(w, self.cfg.data.audio.sample_rate)
        return np.asarray(w, np.float32)

    def _decode_text(self, ids: Sequence[int]) -> str:
        text = self.tokenizer.decode(ids, group_tokens=False)
        return compose_jamo(text) if self.compose_hangul else text

    def _features(self, waves: Sequence[np.ndarray]):
        S = max(len(w) for w in waves)
        batch = np.zeros((len(waves), S), np.float32)
        lengths = np.zeros((len(waves),), np.int32)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = w
            lengths[i] = len(w)
        return self.frontend(torch.from_numpy(batch).to(self.device),
                             torch.from_numpy(lengths).to(self.device))

    def transcribe(self, wav: Union[str, np.ndarray]) -> str:
        return self.transcribe_batch([wav])[0]

    def transcribe_batch(self, wavs: Sequence[Union[str, np.ndarray]]) -> List[str]:
        waves = [self._to_wave(w) for w in wavs]
        blank = self.tokenizer.blank_token_id
        max_symbols = self.cfg.train.greedy_max_symbols
        with torch.inference_mode():
            feats, feat_lengths = self._features(waves)
            if self.fused:
                dec = self._host_beam()
                return [self._decode_text(dec.decode(feats[i:i + 1],
                                                     feat_lengths[i:i + 1])[0])
                        for i in range(len(waves))]
            if self.decoder == "greedy" or self.beam_width <= 1:
                toks, lens = greedy_decode(
                    self.model, feats, feat_lengths, blank_id=blank,
                    max_symbols=max_symbols, max_output_len=self.max_output_len)
            else:
                toks, lens, _ = batched_beam_decode(
                    self.model, feats, feat_lengths, blank_id=blank,
                    beam_width=self.beam_width, max_symbols=max_symbols,
                    max_output_len=self.max_output_len, device_lm=self.device_lm)
                toks, lens = toks[:, 0], lens[:, 0]
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        return [self._decode_text(toks[i, :lens[i]]) for i in range(len(waves))]

    def _host_beam(self):
        from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
        from rnntransducer_tpu_torch.decode.hotwords import DEFAULT_HOTWORD_WEIGHT
        inf = self.cfg.inference
        return BeamSearchDecoder(
            self.model, blank_id=self.tokenizer.blank_token_id,
            tokenizer=self.tokenizer, beam_width=self.beam_width,
            improved=inf.improved, state_beam=inf.state_beam,
            expand_beam=inf.expand_beam, lm=self.lm, hotwords=self.hotwords,
            hotword_weight=(DEFAULT_HOTWORD_WEIGHT if self.hotword_weight is None
                            else self.hotword_weight))

    def transcribe_with_timestamps(self, wav: Union[str, np.ndarray]
                                   ) -> Tuple[str, List[Tuple[str, float]]]:
        """Greedy decode with per-token emission times: ``(text, [(token_text,
        start_sec), ...])``, a frame converted to seconds as
        frame * time_reduction_stride * hop."""
        wave = self._to_wave(wav)
        with torch.inference_mode():
            feats, feat_lengths = self._features([wave])
            toks, lens, times = greedy_decode_with_times(
                self.model, feats, feat_lengths,
                blank_id=self.tokenizer.blank_token_id,
                max_symbols=self.cfg.train.greedy_max_symbols,
                max_output_len=self.max_output_len)
        n = int(lens[0])
        ids = [int(t) for t in toks[0, :n].cpu()]
        sec = (self.cfg.model.transnet.time_reduction_stride
               * self.cfg.data.audio.window_stride_sec)
        stamps = [(self.tokenizer.decode([i]), float(f) * sec)
                  for i, f in zip(ids, times[0, :n].cpu().tolist())]
        return self._decode_text(ids), stamps

    def stream(self, chunk_frames: Optional[int] = None, **kw):
        """A new streaming session (the encoder must be unidirectional).

        A model trained with per-utterance normalisation
        (``cfg.data.audio.normalize``) streams with the causal "running"
        normalisation by default; pass normalize="none" / "running" /
        "fixed" (with norm_mean / norm_var) to override.  Fused recognizers
        stream through the host A/B beam, a ``device_lm`` rides in the
        device beam.
        """
        from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
        kw.setdefault("normalize",
                      "running" if self.cfg.data.audio.normalize else "none")
        if self.fused:
            inf = self.cfg.inference
            kw.setdefault("lm", self.lm)
            kw.setdefault("hotwords", self.hotwords)
            kw.setdefault("hotword_weight", self.hotword_weight)
            kw.setdefault("tokenizer", self.tokenizer)
            kw.setdefault("improved", inf.improved)
            kw.setdefault("state_beam", inf.state_beam)
            kw.setdefault("expand_beam", inf.expand_beam)
        elif self.device_lm is not None and self.decoder != "greedy":
            kw.setdefault("device_lm", self.device_lm)
        kw.setdefault("max_output_len", self.max_output_len)
        return StreamingRecognizer(
            self.model, self.cfg.data.audio,
            blank_id=self.tokenizer.blank_token_id,
            chunk_frames=chunk_frames or self.cfg.inference.streaming_chunk_frames,
            max_symbols=self.cfg.train.greedy_max_symbols,
            decoder="beam" if self.decoder != "greedy" else "greedy",
            beam_width=self.beam_width, **kw)
