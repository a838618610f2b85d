"""N-gram LM for shallow fusion (port of ``rnntransducer_tpu/decode/ngram_lm.py``):
the repository's native scorer ``native/ngram_lm.cpp``, bound with the
port's own ``ctypes`` wrapper.

The library is compiled with ``g++`` at first use into
``build/native/libngram_lm-<hash>.so`` at the root of the checkout (the hash
covers the source), as ``data/collate.py`` builds the batch packer; nothing
is written under ``native/``.  A failed build raises.

Scoring follows pyctcdecode's ``LanguageModel``:

* ``score(state, word, is_last_word)``: the backoff n-gram log-prob,
  converted from ARPA log10 to natural log, times ``alpha`` (the LM
  weight), plus the word-insertion bonus ``beta``; an OOV word takes a
  fixed penalty; ``is_last_word`` also scores ``</s>``;
* ``score_partial_token(tok)``: 0 if some vocabulary word starts with
  ``tok``, else a length-scaled unknown penalty.

The state is the tuple of the last (order-1) word ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

_LOG10 = math.log(10.0)
UNK_PENALTY = -10.0        # pyctcdecode UNK_SCORE_OFFSET
AVG_TOKEN_LEN = 6          # pyctcdecode AVG_TOKEN_LEN
DEFAULT_ALPHA = 0.5
DEFAULT_BETA = 1.5

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "ngram_lm.cpp"
_BUILD_DIR = _ROOT / "build" / "native"

LMState = Tuple[int, ...]  # last (order-1) word ids


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libngram_lm-{digest}.so"


def _build(so: Path) -> None:
    # built under a process-private name and renamed, so that concurrent
    # first calls never load a half-written library
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                        tmp, str(_SOURCE)], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise RuntimeError(f"cannot build the n-gram LM library from {_SOURCE}: "
                           f"{e} {detail.decode(errors='replace')}") from e
    os.replace(tmp, so)


def _load_lib() -> ctypes.CDLL:
    so = _library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.ngram_load.restype = ctypes.c_void_p
    lib.ngram_load.argtypes = [ctypes.c_char_p]
    lib.ngram_free.argtypes = [ctypes.c_void_p]
    lib.ngram_order.restype = ctypes.c_int
    lib.ngram_order.argtypes = [ctypes.c_void_p]
    lib.ngram_vocab_size.restype = ctypes.c_int
    lib.ngram_vocab_size.argtypes = [ctypes.c_void_p]
    lib.ngram_word_id.restype = ctypes.c_int
    lib.ngram_word_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_score.restype = ctypes.c_float
    lib.ngram_score.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int, ctypes.c_int32]
    lib.ngram_has_prefix.restype = ctypes.c_int
    lib.ngram_has_prefix.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_kenlm_error.restype = ctypes.c_int
    lib.ngram_kenlm_error.argtypes = []
    return lib


_lib: Optional[ctypes.CDLL] = None


def _lib_handle() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


def _resolve_pyctcdecode_dir(d: str) -> Tuple[str, dict]:
    """The LM file and attrs inside a pyctcdecode ``save_to_dir`` layout: a
    directory holding the kenlm / ARPA model under its own name and
    ``attrs.json`` with the fusion weights.  File names drifted across
    pyctcdecode versions, so the model is matched by extension."""
    attrs: dict = {}
    model = None
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        low = name.lower()
        if low.endswith("attrs.json"):
            with open(p) as f:
                attrs = json.load(f)
        elif low.endswith((".arpa", ".arpa.gz", ".bin", ".binary")) or (
                low.endswith(".gz") and ".arpa" in low):
            model = p
    if model is None:
        raise FileNotFoundError(
            f"no .arpa/.bin LM file inside directory {d} (expected a "
            "pyctcdecode save_to_dir layout)")
    return model, attrs


# error codes of the native ngram_kenlm_error() when a kenlm binary is refused
_KENLM_ERRORS = {
    1: "cannot open file",
    2: "not a kenlm 'format version 5' binary",
    3: "sanity/header mismatch (32-bit or foreign-endian build?)",
    4: "unsupported kenlm model type (PROBING and TRIE binaries are "
       "supported; rebuild with `build_binary probing|trie lm.arpa lm.bin`, "
       "or pass the .arpa directly — this loader reads ARPA natively)",
    5: "binary lacks trailing vocabulary strings (rebuild without -w "
       "suppression, or pass the .arpa directly)",
    6: "table layout drift detected (entry counts / prob ranges implausible "
       "for this kenlm version — pass the .arpa directly)",
    7: "bhiksha-array trie binaries (-a) are unsupported (rebuild without "
       "-a: `build_binary [-q N -b M] trie lm.arpa lm.bin`, or pass the "
       ".arpa directly)",
    8: "quantized-trie layout drift detected (quant header / table sizes "
       "implausible for this kenlm version — rebuild unquantized or pass "
       "the .arpa directly)",
}


class NGramLM:
    """N-gram LM with KenLM-style shallow-fusion scoring.

    ``load`` takes a text ARPA file (optionally ``.arpa.gz``), a kenlm
    ``format version 5`` PROBING or TRIE binary (unquantized and quantized
    tries; bhiksha-array tries are refused with a rebuild hint), or a
    pyctcdecode ``save_to_dir`` directory (``attrs.json`` with alpha / beta /
    unk_score_offset beside the model file).
    """

    def __init__(self, handle: int, alpha: float = DEFAULT_ALPHA,
                 beta: float = DEFAULT_BETA, unk_offset: float = UNK_PENALTY):
        self._h = handle
        self._lib = _lib_handle()
        self.order = self._lib.ngram_order(self._h)
        self.alpha = alpha
        self.beta = beta
        self.unk_offset = unk_offset
        self._bos = self.word_id("<s>")
        self._eos = self.word_id("</s>")

    @classmethod
    def load(cls, path: str, weight: Optional[float] = None,
             beta: Optional[float] = None) -> "NGramLM":
        alpha_d, beta_d, unk_d = DEFAULT_ALPHA, DEFAULT_BETA, UNK_PENALTY
        if os.path.isdir(path):
            path, attrs = _resolve_pyctcdecode_dir(path)
            alpha_d = attrs.get("alpha", alpha_d)
            beta_d = attrs.get("beta", beta_d)
            unk_d = attrs.get("unk_score_offset", unk_d)
        tmp = None
        if path.endswith(".gz"):
            import gzip
            import tempfile
            with gzip.open(path, "rb") as f:
                data = f.read()
            tmp = tempfile.NamedTemporaryFile(suffix=".arpa", delete=False)
            tmp.write(data)
            tmp.close()
            path = tmp.name
        try:
            lib = _lib_handle()
            h = lib.ngram_load(path.encode())
            if not h:
                detail = _KENLM_ERRORS.get(lib.ngram_kenlm_error(),
                                           "unreadable ARPA file")
                raise FileNotFoundError(f"cannot load LM {path}: {detail}")
        finally:
            if tmp is not None:
                os.unlink(tmp.name)
        return cls(h, alpha=alpha_d if weight is None else weight,
                   beta=beta_d if beta is None else beta, unk_offset=unk_d)

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None) is not None:
            self._lib.ngram_free(self._h)
            self._h = None

    # -- low level -----------------------------------------------------
    def word_id(self, word: str) -> int:
        return self._lib.ngram_word_id(self._h, word.encode())

    def raw_score(self, context_ids: Tuple[int, ...], word_id: int) -> float:
        """log10 P(word | context) with backoff."""
        arr = (ctypes.c_int32 * len(context_ids))(*context_ids)
        return self._lib.ngram_score(self._h, arr, len(context_ids), word_id)

    def has_prefix(self, prefix: str) -> bool:
        return bool(self._lib.ngram_has_prefix(self._h, prefix.encode()))

    # -- pyctcdecode-compatible surface ---------------------------------
    def get_start_state(self) -> LMState:
        return (self._bos,) if self._bos >= 0 else ()

    def score(self, prev_state: LMState, word: str,
              is_last_word: bool = False) -> Tuple[float, LMState]:
        wid = self.word_id(word)
        if wid < 0:
            lm_log10 = self.unk_offset / _LOG10  # OOV penalty (natural units)
            new_state = prev_state
        else:
            lm_log10 = self.raw_score(prev_state or (), wid)
            # keep the last order-1 words; [-0:] would keep everything, so an
            # order-1 LM's state is pinned to () explicitly
            keep = self.order - 1
            new_state = ((tuple(prev_state or ()) + (wid,))[-keep:]
                         if keep > 0 else ())
        score = self.alpha * lm_log10 * _LOG10 + self.beta
        if is_last_word and self._eos >= 0:
            score += self.alpha * self.raw_score(new_state, self._eos) * _LOG10
        return score, new_state

    def score_partial_token(self, partial: str) -> float:
        if not partial:
            return 0.0
        unk = 0.0 if self.has_prefix(partial) else self.unk_offset
        if len(partial) > AVG_TOKEN_LEN:
            unk = unk * len(partial) / AVG_TOKEN_LEN
        return self.alpha * unk
