"""Device-resident word-boundary n-gram LM fusion for the batched beam (port
of ``rnntransducer_tpu/decode/device_word_lm.py``).

The lexicon and a word n-gram live on the card as dense tables, and
word-boundary rescoring happens inside the beam's frame loop with no host
round trip.  Per hypothesis:

* a lexicon trie DFA over graphemes tracks the in-progress word:
  ``trie_next[node, grapheme] -> node`` (root 0; a prefix that leaves the
  lexicon falls into an absorbing DEAD node).  An appended grapheme
  advances the node; an appended word delimiter resets it to the root;
* ``node_word[node]`` is the word id the node exactly completes
  (``n_words`` = not a word, scored as OOV);
* a delimiter extension gains ``rows[state, node_word[node]]`` before
  top-K selection (an empty current word, node == root, scores nothing);
* the LM state is the previous in-vocabulary word id (``n_words`` = the
  start-of-stream ``<s>`` state); an OOV word leaves it unchanged, as the
  host scorer does (``ngram_lm.py`` ``score``).

``rows`` bakes the host formula per (state, word), ``alpha * ln p(w |
state) + beta``, with the OOV column at ``alpha * unk_offset + beta``.
``beam_batched.settle_word_lm`` applies the host path's ``is_last_word``
rule at the end of the stream.  The tables are dense: ``rows`` is (W+1)^2
floats, so this targets lexicons of up to a few thousand words; an LM of
higher order projects onto its bigram marginals (context = last word).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

_LOG10 = math.log(10.0)


class DeviceWordLM:
    """Dense tables for word-boundary fusion (module docstring).

    ``trie_next``: (N, V) int64; ``node_word``: (N,) int64 (``n_words`` =
    OOV); ``rows``: (W+1, W+1) float32 fused scores, row = LM state (W =
    start), column = completed word (W = OOV); ``eos_col``: (W+1,) float32
    ``alpha * ln p(</s> | state)``; ``next_state``: (W+1,) int64, the state
    after completing word w (-1 = keep the previous state);
    ``delimiter_id``: the grapheme id that closes words."""

    def __init__(self, trie_next, node_word, rows, eos_col, next_state,
                 delimiter_id: int):
        self.trie_next = torch.as_tensor(trie_next, dtype=torch.int64)
        self.node_word = torch.as_tensor(node_word, dtype=torch.int64)
        self.rows = torch.as_tensor(rows, dtype=torch.float32)
        self.eos_col = torch.as_tensor(eos_col, dtype=torch.float32)
        self.next_state = torch.as_tensor(next_state, dtype=torch.int64)
        self.delimiter_id = int(delimiter_id)

    @property
    def n_words(self) -> int:
        return self.rows.shape[1] - 1

    @property
    def start_state(self) -> int:
        return self.rows.shape[0] - 1

    def to(self, device) -> "DeviceWordLM":
        """These tables on ``device`` (self when they are there)."""
        if self.rows.device == torch.device(device):
            return self
        return DeviceWordLM(*(t.to(device) for t in (
            self.trie_next, self.node_word, self.rows, self.eos_col,
            self.next_state)), self.delimiter_id)


def build_device_word_lm(lm, tokenizer, words: Sequence,
                         delimiter_id: Optional[int] = None) -> DeviceWordLM:
    """The tables from a host ``NGramLM`` and its lexicon.

    ``lm``'s ``alpha`` / ``beta`` / ``unk_offset`` are baked into the
    tables, so device scores match the host ``score()`` formula.  ``words``:
    the closed lexicon, each a grapheme string the tokenizer round-trips or
    a sequence of grapheme ids (the safe form for vocabularies with
    multi-character token names).  ``delimiter_id`` defaults to the
    tokenizer's word-delimiter token.
    """
    if delimiter_id is None:
        delimiter_id = tokenizer.word_delimiter_token_id
        if delimiter_id is None:
            raise ValueError("word-boundary fusion needs a word-delimiter "
                             "token (grapheme vocab.json)")
    V = tokenizer.vocab_size
    W = len(words)
    if W == 0:
        raise ValueError("empty lexicon")

    # ---- lexicon trie over grapheme ids (root 0, DEAD absorbing) ----
    seqs: List[List[int]] = []
    for w in words:
        if isinstance(w, str):
            ids = tokenizer.encode(w)
            if (not ids or any(i == delimiter_id for i in ids)
                    or tokenizer.decode(ids, group_tokens=False) != w):
                raise ValueError(
                    f"lexicon word {w!r} does not round-trip through the "
                    "tokenizer (special/multi-char token names?) — pass "
                    "grapheme-id sequences instead")
        else:
            ids = [int(g) for g in w]
            if not ids or any(i == delimiter_id for i in ids):
                raise ValueError(f"lexicon id-sequence {w!r} is empty or "
                                 "contains the delimiter")
        seqs.append(ids)
    children: List[dict] = [{}]  # node -> {grapheme: node}
    node_of_word = {}
    for wi, ids in enumerate(seqs):
        n = 0
        for g in ids:
            nxt = children[n].get(g)
            if nxt is None:
                children.append({})
                nxt = len(children) - 1
                children[n][g] = nxt
            n = nxt
        node_of_word[n] = wi  # duplicate words: the last one wins
    N = len(children) + 1  # + DEAD
    trie_next = np.full((N, V), N - 1, np.int64)
    for n, ch in enumerate(children):
        for g, nxt in ch.items():
            trie_next[n, g] = nxt
    node_word = np.full((N,), W, np.int64)
    for n, wi in node_of_word.items():
        node_word[n] = wi

    # ---- fused score rows per LM state (the host formula) ----
    # id-sequence words look the LM up by their joined token names, the
    # convention of an ARPA built from this lexicon
    wids = [lm.word_id(w if isinstance(w, str) else
                       "".join(tokenizer.ids_to_tokens[g] for g in w))
            for w in words]
    alpha, beta = lm.alpha, lm.beta
    bos, eos = lm.word_id("<s>"), lm.word_id("</s>")
    states = [((wid,) if wid >= 0 else ()) for wid in wids]
    states.append((bos,) if bos >= 0 else ())  # start state (index W)
    rows = np.full((W + 1, W + 1), alpha * lm.unk_offset + beta, np.float32)
    eos_col = np.zeros((W + 1,), np.float32)
    for s, ctx in enumerate(states):
        for j, wid in enumerate(wids):
            if wid >= 0:
                rows[s, j] = alpha * _LOG10 * lm.raw_score(ctx, wid) + beta
        if eos >= 0:
            eos_col[s] = alpha * _LOG10 * lm.raw_score(ctx, eos)
    next_state = np.full((W + 1,), -1, np.int64)
    for j, wid in enumerate(wids):
        if wid >= 0:
            next_state[j] = j
    return DeviceWordLM(trie_next, node_word, rows, eos_col, next_state,
                        delimiter_id)
