"""Device-resident character n-gram LM for frame-synchronous fusion (port of
``rnntransducer_tpu/decode/device_lm.py``).

A grapheme-level n-gram LM materialised as a dense, backoff-resolved
log-prob table: built once on the host from any LM file ``NGramLM.load``
takes, then kept on the card and gathered inside the beam's frame loop
(``decode/beam_batched.py``), one (B, K, V) row gather per expansion round
and no host sync.  For a 72-grapheme vocabulary order 2 is 72^2 floats
(20 KB) and order 3 72^3 (1.5 MB).

Fusion: every non-blank extension gains ``weight * ln p(c | ctx)``, where
``ctx`` is the hypothesis's last ``order-1`` emitted graphemes (consecutive
duplicate drops follow the token buffer); blank transitions are not LM
events.  Contexts shorter than ``order-1`` back off to the lower-order
distribution: the blank id in a context slot means "no history there".
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_LOG10 = math.log(10.0)

# score of graphemes with no LM word (specials, OOV): the order of magnitude
# of the host path's pyctcdecode-style UNK offset
DEFAULT_OOV_LOGP = -10.0


class DeviceCharLM:
    """A dense char-LM table plus its fusion weight.

    ``table``: (V,) * order natural-log ``p(c | c_{-order+1} .. c_{-1})``
    with ARPA backoff resolved at build time, a float32 tensor (numpy
    arrays are converted); ``to(device)`` puts it on the card.  ``weight``:
    the shallow-fusion scale.
    """

    def __init__(self, table, weight: float = 0.3):
        if table.ndim < 2:
            raise ValueError("char-LM table must be at least order 2 "
                             f"(got ndim={table.ndim})")
        self.table = torch.as_tensor(table, dtype=torch.float32)
        self.weight = float(weight)

    @property
    def order(self) -> int:
        return self.table.ndim

    @property
    def context(self) -> int:
        """Tokens of history the beam carry must track (order - 1)."""
        return self.table.ndim - 1

    def to(self, device) -> "DeviceCharLM":
        """This LM with its table on ``device`` (self when it is there)."""
        if self.table.device == torch.device(device):
            return self
        return DeviceCharLM(self.table.to(device), self.weight)

    @classmethod
    def load(cls, path: str, tokenizer, weight: float = 0.3,
             max_order: Optional[int] = None,
             oov_logp: float = DEFAULT_OOV_LOGP) -> "DeviceCharLM":
        """Build from any LM file ``NGramLM.load`` takes; the LM's words must
        be the tokenizer's graphemes (a char-level LM)."""
        from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM

        lm = NGramLM.load(path)
        return cls(build_char_lm_table(lm, tokenizer, max_order=max_order,
                                       oov_logp=oov_logp), weight=weight)


def _token_strings(tokenizer) -> List[Optional[str]]:
    """Token id -> LM word string; None for ids that are not LM events
    (blank / pad, unk, bos / eos, <extra_*> fillers).  The word delimiter
    maps to itself: a char LM trained on delimiter-separated text scores it
    like any grapheme."""
    V = tokenizer.vocab_size
    out: List[Optional[str]] = [None] * V
    special = getattr(tokenizer, "_special_ids", set())
    for i in range(V):
        tok = tokenizer.ids_to_tokens.get(i)
        if tok is None or i in special:
            continue
        out[i] = tok
    return out


def build_char_lm_table(lm, tokenizer, max_order: Optional[int] = None,
                        oov_logp: float = DEFAULT_OOV_LOGP,
                        dtype=np.float32) -> np.ndarray:
    """``ln p(c | ctx)`` for every (context, char) pair as a dense
    ``(V,) * order`` numpy array, ARPA backoff resolved by the native scorer
    (``NGramLM.raw_score``).

    Context slots holding the blank id (or any non-LM token) are skipped
    when forming the LM history, so rows "containing blank" hold the
    lower-order distribution, which is what the beam carry's
    blank-initialised context gives at sequence start.  V^order lookups
    through a resolved-context cache; more than 1e6 entries is refused
    unless ``max_order`` lowers the order.
    """
    order = lm.order if max_order is None else min(lm.order, max_order)
    if order < 2:
        raise ValueError(f"char LM must be at least order 2 (got {order})")
    V = tokenizer.vocab_size
    if V ** order > 1_000_000:
        raise ValueError(
            f"dense char-LM table V^order = {V}^{order} = {V ** order:,} "
            "entries is too large to materialize; pass max_order<=3 (the "
            "host LM-fusion path has no order limit)")
    wids = [lm.word_id(w) if w is not None else -1
            for w in _token_strings(tokenizer)]

    # one scored row per resolved (blank-skipped) context: contexts that only
    # differ in where their blanks sit share rows
    row_cache: Dict[Tuple[int, ...], np.ndarray] = {}

    def row(ctx_wids: Tuple[int, ...]) -> np.ndarray:
        r = row_cache.get(ctx_wids)
        if r is None:
            r = np.full((V,), oov_logp, dtype)
            for v in range(V):
                if wids[v] >= 0:
                    r[v] = _LOG10 * lm.raw_score(ctx_wids, wids[v])
            row_cache[ctx_wids] = r
        return r

    table = np.empty((V,) * order, dtype)
    for ctx in itertools.product(range(V), repeat=order - 1):
        table[ctx] = row(tuple(wids[c] for c in ctx if wids[c] >= 0))
    return table
