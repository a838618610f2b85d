"""Grapheme tokenizer (Wav2Vec2CTC-vocab-compatible, dependency-free).

The PyTorch port's own copy of ``rnntransducer_tpu/tokenizer.py``: same
vocab formats, same ids, same decode rules.

The reference uses ``transformers.Wav2Vec2CTCTokenizer(vocab_file=...)``
(``model.py:24``) over a 72-entry Korean-jamo vocab (``README.md:41``,
``config/config.json:13,21``) with ``blank == pad == 0`` (``model.py:25``).
This module re-implements that surface natively so the framework has no
tokenizer dependency on torch/transformers:

* loads/saves the same ``vocab.json`` format ({token: id}),
* ``|`` is the word-delimiter token (space on decode),
* ``decode``/``batch_decode`` mirror Wav2Vec2CTCTokenizer semantics
  (consecutive-duplicate grouping, special-token skipping).
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Sequence

PAD = "<pad>"
UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"
WORD_DELIMITER = "|"

# Korean compatibility jamo: consonants U+3131..U+314E, vowels U+314F..U+3163.
_JAMO = [chr(c) for c in range(0x3131, 0x3164)]


def build_default_vocab(target_size: int = 72) -> dict:
    """Default Korean-jamo vocab: 4 specials + word delimiter + 51 compat jamo,
    padded with reserved tokens up to ``target_size`` (the reference's vocab
    has 72 entries; its exact token list is data, not code)."""
    tokens = [PAD, UNK, BOS, EOS, WORD_DELIMITER] + _JAMO
    if len(tokens) > target_size:
        raise ValueError(f"target_size {target_size} < base vocab {len(tokens)}")
    tokens += [f"<extra_{i}>" for i in range(target_size - len(tokens))]
    return {tok: i for i, tok in enumerate(tokens)}


class GraphemeTokenizer:
    """CTC/RNN-T grapheme tokenizer with blank == pad == id 0."""

    def __init__(self, vocab: dict, word_delimiter_token: str = WORD_DELIMITER):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        if len(self.ids_to_tokens) != len(self.vocab):
            raise ValueError("vocab has duplicate ids")
        self.word_delimiter_token = word_delimiter_token
        self.pad_token_id = self.vocab.get(PAD, 0)
        self.blank_token_id = self.pad_token_id  # model.py:25
        self.unk_token_id = self.vocab.get(UNK, self.pad_token_id)
        self.bos_token_id = self.vocab.get(BOS, 2)
        self.eos_token_id = self.vocab.get(EOS, 3)
        self.word_delimiter_token_id = self.vocab.get(word_delimiter_token)
        self._special_ids = {
            self.vocab[t] for t in (PAD, UNK, BOS, EOS) if t in self.vocab
        } | {i for t, i in self.vocab.items() if t.startswith("<extra_")}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_file(cls, vocab_path: str) -> "GraphemeTokenizer":
        with open(vocab_path) as f:
            return cls(json.load(f))

    @classmethod
    def default(cls, vocab_size: int = 72) -> "GraphemeTokenizer":
        return cls(build_default_vocab(vocab_size))

    def save(self, vocab_path: str) -> None:
        with open(vocab_path, "w") as f:
            json.dump(self.vocab, f, ensure_ascii=False, indent=1)

    # -- core API ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        """Text -> grapheme ids. Spaces map to the word delimiter."""
        ids = []
        for ch in text:
            if ch == " ":
                if self.word_delimiter_token_id is None:
                    # fail here, not as a TypeError deep in the data
                    # pipeline when a None id hits an int array
                    raise ValueError(
                        "text contains spaces but the vocab has no "
                        f"word-delimiter token {self.word_delimiter_token!r}")
                ids.append(self.word_delimiter_token_id)
            else:
                ids.append(self.vocab.get(ch, self.unk_token_id))
        return ids

    def decode(
        self,
        token_ids: Sequence[int],
        group_tokens: bool = True,
        skip_special_tokens: bool = True,
    ) -> str:
        """Ids -> text. Mirrors Wav2Vec2CTCTokenizer.decode: consecutive
        duplicates are grouped (the reference decodes RNN-T outputs through
        the CTC tokenizer, model.py:77-78), specials are dropped, ``|`` maps
        to a space, and whitespace is collapsed."""
        toks: List[str] = []
        prev = None
        for i in token_ids:
            i = int(i)
            if group_tokens and prev is not None and i == prev:
                continue
            prev = i
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self.ids_to_tokens.get(i)
            if tok is None:
                continue
            toks.append(" " if tok == self.word_delimiter_token else tok)
        return " ".join("".join(toks).split())

    def batch_decode(self, batch: Iterable[Sequence[int]], **kw) -> List[str]:
        return [self.decode(ids, **kw) for ids in batch]


# -- Hangul syllable <-> jamo -----------------------------------------------
# The reference's KsponSpeech prep produced jamo-level labels (README.md:41:
# 72 graphemes, syllables decomposed). These helpers make encode()/decode()
# usable on real Korean text: syllables decompose to compatibility jamo for
# encoding, and jamo sequences re-compose to syllables for display.

_CHO = [0x3131, 0x3132, 0x3134, 0x3137, 0x3138, 0x3139, 0x3141, 0x3142,
        0x3143, 0x3145, 0x3146, 0x3147, 0x3148, 0x3149, 0x314A, 0x314B,
        0x314C, 0x314D, 0x314E]  # 19 initials (compat jamo codepoints)
_JUNG = list(range(0x314F, 0x3164))  # 21 medials
_JONG = [0, 0x3131, 0x3132, 0x3133, 0x3134, 0x3135, 0x3136, 0x3137, 0x3139,
         0x313A, 0x313B, 0x313C, 0x313D, 0x313E, 0x313F, 0x3140, 0x3141,
         0x3142, 0x3144, 0x3145, 0x3146, 0x3147, 0x3148, 0x314A, 0x314B,
         0x314C, 0x314D, 0x314E]  # 28 finals (0 = none)


def decompose_hangul(text: str) -> str:
    """Hangul syllables -> compatibility jamo; other chars pass through.
    '간다' -> 'ㄱㅏㄴㄷㅏ'."""
    out = []
    for ch in text:
        code = ord(ch)
        if 0xAC00 <= code <= 0xD7A3:
            idx = code - 0xAC00
            cho, rest = divmod(idx, 21 * 28)
            jung, jong = divmod(rest, 28)
            out.append(chr(_CHO[cho]))
            out.append(chr(_JUNG[jung]))
            if _JONG[jong]:
                out.append(chr(_JONG[jong]))
        else:
            out.append(ch)
    return "".join(out)


def compose_jamo(text: str) -> str:
    """Best-effort inverse of decompose_hangul: greedy recombination of
    compatibility jamo runs into syllables; unmatched jamo pass through."""
    out = []
    i = 0
    n = len(text)
    cho_set = {chr(c) for c in _CHO}
    jung_set = {chr(c) for c in _JUNG}
    jong_map = {chr(c): j for j, c in enumerate(_JONG) if c}
    while i < n:
        ch = text[i]
        if ch in cho_set and i + 1 < n and text[i + 1] in jung_set:
            cho = _CHO.index(ord(ch))
            jung = _JUNG.index(ord(text[i + 1]))
            i += 2
            jong = 0
            # a final is consumed only if NOT itself the start of a next
            # syllable (i.e. not followed by a medial)
            if i < n and text[i] in jong_map and not (
                    i + 1 < n and text[i + 1] in jung_set):
                jong = jong_map[text[i]]
                i += 1
            out.append(chr(0xAC00 + (cho * 21 + jung) * 28 + jong))
        else:
            out.append(ch)
            i += 1
    return "".join(out)


# -- subword (BPE) tokenizer --------------------------------------------------
# Beyond-reference breadth: the reference is grapheme-only
# (Wav2Vec2CTCTokenizer over 72 jamo, reference model.py:24); production
# RNN-T systems usually run subword outputs (fewer, higher-entropy emissions
# -> shorter U lattices and faster decode).  SubwordTokenizer keeps the exact
# contract every decode surface relies on — blank == pad == id 0, encode() ->
# int ids, decode(ids, group_tokens=, skip_special_tokens=) -> text — so the
# model/config only see a different num_classes.  Word boundaries ride
# sentencepiece-style "▁"-prefixed pieces instead of a "|" token, so
# word_delimiter_token_id is None: the host A/B beam's word-level LM fusion
# (decode/beam.py:183) refuses subword vocabs; greedy, the device beams, the
# device char-LM, and hotword boosting all work unchanged.

_WORD_MARK = "▁"  # ▁


def _bpe_word_symbols(word: str) -> List[str]:
    return [_WORD_MARK + word[0]] + list(word[1:])


def train_bpe(corpus: Iterable[str], vocab_size: int,
              normalize: str = "jamo") -> "SubwordTokenizer":
    """Train a byte-pair-encoding vocab on an iterable of text lines.

    Classic BPE: start from characters (word-initial chars carry the ``▁``
    mark), repeatedly merge the most frequent adjacent pair until
    ``vocab_size`` pieces exist (specials included) or no pair repeats.
    Deterministic: ties break lexicographically.

    ``normalize="jamo"`` decomposes Hangul syllables before counting (and in
    ``encode``), matching the framework's data-prep convention
    (``scripts/prepare_manifest.py``); pass ``"none"`` to model raw text
    (syllable-level pieces) — API-only: the CLI prep paths decompose first.
    """
    if vocab_size < 8:
        raise ValueError(f"vocab_size {vocab_size} is too small")
    norm = decompose_hangul if normalize == "jamo" else (lambda t: t)
    words: dict = {}
    for line in corpus:
        for w in norm(line).split():
            words[w] = words.get(w, 0) + 1
    if not words:
        raise ValueError("empty corpus")
    seqs = {w: _bpe_word_symbols(w) for w in words}
    pieces = sorted({s for seq in seqs.values() for s in seq})
    merges: List[tuple] = []
    n_specials = 4  # <pad> <unk> <s> </s>
    while len(pieces) + n_specials < vocab_size:
        counts: dict = {}
        for w, seq in seqs.items():
            c = words[w]
            for a, b in zip(seq, seq[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + c
        if not counts:
            break
        best = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if counts[best] < 2:
            break  # singleton pairs make pieces that never generalize
        merged = best[0] + best[1]
        merges.append(best)
        pieces.append(merged)
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if (i + 1 < len(seq) and seq[i] == best[0]
                        and seq[i + 1] == best[1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    vocab = {PAD: 0, UNK: 1, BOS: 2, EOS: 3}
    for p in sorted(pieces):
        vocab[p] = len(vocab)
    return SubwordTokenizer(vocab, merges, normalize=normalize)


class SubwordTokenizer:
    """BPE subword tokenizer with blank == pad == id 0 (same decode-surface
    contract as GraphemeTokenizer)."""

    def __init__(self, vocab: dict, merges: Sequence[Sequence[str]],
                 normalize: str = "jamo"):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        if len(self.ids_to_tokens) != len(self.vocab):
            raise ValueError("vocab has duplicate ids")
        self.merges = [tuple(m) for m in merges]
        self._rank = {m: r for r, m in enumerate(self.merges)}
        self.normalize = normalize
        self.pad_token_id = self.vocab.get(PAD, 0)
        self.blank_token_id = self.pad_token_id
        self.unk_token_id = self.vocab.get(UNK, self.pad_token_id)
        self.bos_token_id = self.vocab.get(BOS, 2)
        self.eos_token_id = self.vocab.get(EOS, 3)
        # no word-delimiter TOKEN: boundaries live in the ▁ piece mark.
        # Host word-LM fusion keys off this being None and refuses.
        self.word_delimiter_token = None
        self.word_delimiter_token_id = None
        self._special_ids = {self.vocab[t]
                             for t in (PAD, UNK, BOS, EOS) if t in self.vocab}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "SubwordTokenizer":
        with open(path) as f:
            blob = json.load(f)
        if "merges" not in blob:
            raise ValueError(f"{path} is not a subword tokenizer file "
                             "(no 'merges'; plain vocab.json is the "
                             "grapheme format)")
        return cls(blob["vocab"], blob["merges"],
                   normalize=blob.get("normalize", "jamo"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "bpe", "normalize": self.normalize,
                       "vocab": self.vocab,
                       "merges": [list(m) for m in self.merges]},
                      f, ensure_ascii=False, indent=1)

    # -- core API ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _encode_word(self, word: str) -> List[str]:
        seq = _bpe_word_symbols(word)
        while len(seq) > 1:
            ranked = [(self._rank[p], i)
                      for i, p in enumerate(zip(seq, seq[1:]))
                      if p in self._rank]
            if not ranked:
                break
            r, i = min(ranked)
            seq = seq[:i] + [seq[i] + seq[i + 1]] + seq[i + 2:]
        return seq

    def encode(self, text: str) -> List[int]:
        """Text -> subword ids (unknown pieces fall back per-character, then
        to <unk>). Hangul decomposes first when normalize == 'jamo' —
        idempotent, so pre-decomposed pipeline text encodes identically."""
        if self.normalize == "jamo":
            text = decompose_hangul(text)
        ids: List[int] = []
        for word in text.split():
            for piece in self._encode_word(word):
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                else:  # unseen char (or char+mark): per-char fallback
                    for j, ch in enumerate(piece.lstrip(_WORD_MARK)):
                        key = _WORD_MARK + ch if (j == 0 and
                                                  piece[0] == _WORD_MARK) else ch
                        ids.append(self.vocab.get(
                            key, self.vocab.get(ch, self.unk_token_id)))
        return ids

    def decode(self, token_ids: Sequence[int], group_tokens: bool = True,
               skip_special_tokens: bool = True) -> str:
        toks: List[str] = []
        prev = None
        for i in token_ids:
            i = int(i)
            if group_tokens and prev is not None and i == prev:
                continue
            prev = i
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self.ids_to_tokens.get(i)
            if tok is not None:
                toks.append(tok)
        return " ".join("".join(toks).replace(_WORD_MARK, " ").split())

    def batch_decode(self, batch: Iterable[Sequence[int]], **kw) -> List[str]:
        return [self.decode(ids, **kw) for ids in batch]


def load_tokenizer(path: Optional[str] = None, num_classes: int = 72):
    """Load whichever tokenizer a file holds: a plain ``{token: id}``
    vocab.json -> GraphemeTokenizer (the reference format), a
    ``{"vocab":..., "merges":...}`` bundle -> SubwordTokenizer.  With no
    path, the default grapheme vocab sized to ``num_classes``.  The single
    entry point every CLI uses, so a checkpoint's ``vocab_path`` can name
    either family."""
    if not path:
        return GraphemeTokenizer.default(num_classes)
    with open(path) as f:
        blob = json.load(f)
    if isinstance(blob, dict) and "merges" in blob:
        return SubwordTokenizer(blob["vocab"], blob["merges"],
                                normalize=blob.get("normalize", "jamo"))
    return GraphemeTokenizer(blob)
