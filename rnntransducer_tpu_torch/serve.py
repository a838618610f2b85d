"""Recognition API for serving (port of ``rnntransducer_tpu/serve.py``).

    rec = Recognizer.from_torch_params("bundle")        # config.json + params.pt
    rec = Recognizer.from_checkpoint("checkpoints")     # a Trainer's checkpoints
    text = rec.transcribe("utt.wav")
    texts = rec.transcribe_batch([wav1, wav2])          # one batched greedy decode

Only the greedy decoder is ported.  Beam decoders, LM / hotword fusion and
streaming sessions raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rnntransducer_tpu_torch.config import Config
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


class Recognizer:
    def __init__(self, cfg: Config, state_dict_or_params: Mapping, tokenizer,
                 decoder: str = "greedy", max_output_len: int = 512,
                 compose_hangul: bool = True, precision: Optional[str] = None,
                 device=None, lm_path: Optional[str] = None,
                 hotwords: Optional[Sequence[str]] = None):
        if decoder != "greedy":
            raise NotImplementedError(
                f"decoder {decoder!r} is not ported yet; only 'greedy' is")
        if lm_path or hotwords:
            raise NotImplementedError("LM / hotword fusion is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        sd = state_dict_or_params
        if _is_flax_tree(sd):
            sd = weights.state_dict_from_flax(sd, cfg.model)
        self.model = build_model(cfg, self.device, state_dict=sd)
        # precision: cast the float params once; activations follow them
        # (decode.greedy casts the features to the params' dtype)
        if precision is not None:
            self.model.to(decode_dtype(precision))
        self.tokenizer = tokenizer
        self.decoder = decoder
        self.max_output_len = max_output_len
        self.compose_hangul = compose_hangul
        self.frontend = LogMelFrontend(cfg.data.audio)

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
        with torch.inference_mode():
            feats, feat_lengths = self._features(waves)
            toks, lens = greedy_decode(
                self.model, feats, feat_lengths,
                blank_id=self.tokenizer.blank_token_id,
                max_symbols=self.cfg.train.greedy_max_symbols,
                max_output_len=self.max_output_len)
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        return [self._decode_text(toks[i, :lens[i]]) for i in range(len(waves))]

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

    def stream(self, *args, **kwargs):
        raise NotImplementedError("streaming sessions are not ported yet")
