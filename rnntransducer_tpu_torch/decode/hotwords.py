"""Hotword boosting (port of ``rnntransducer_tpu/decode/hotwords.py``):
completed hotwords found in the text add a length-proportional bonus, and a
partial word that is a prefix of a hotword is boosted so hypotheses heading
toward a hotword survive pruning.  Pure Python, the same semantics."""

from __future__ import annotations

import re
from typing import Iterable, Optional

DEFAULT_HOTWORD_WEIGHT = 10.0


class HotwordScorer:
    def __init__(self, hotwords: Optional[Iterable[str]] = None,
                 weight: float = DEFAULT_HOTWORD_WEIGHT):
        self.weight = weight
        self.hotwords = [w.strip() for w in (hotwords or []) if w.strip()]
        self._pattern = None
        if self.hotwords:
            alts = "|".join(re.escape(w) for w in
                            sorted(self.hotwords, key=len, reverse=True))
            # the trailing boundary is a lookahead: a consuming group would
            # eat the space between adjacent hotwords ("foo bar" -> only foo)
            self._pattern = re.compile(rf"(?:^|\s)({alts})(?=$|\s)")
        self._shortest = min((len(w) for w in self.hotwords), default=0)

    @classmethod
    def build_scorer(cls, hotwords: Optional[Iterable[str]] = None,
                     weight: float = DEFAULT_HOTWORD_WEIGHT) -> "HotwordScorer":
        return cls(hotwords, weight)

    def __bool__(self) -> bool:
        return bool(self.hotwords)

    def __contains__(self, token: str) -> bool:
        """True if token is a prefix of some hotword."""
        return any(w.startswith(token) for w in self.hotwords)

    def score(self, text: str) -> float:
        """Bonus for completed hotwords appearing as words in text."""
        if self._pattern is None or not text:
            return 0.0
        return self.weight * sum(len(m) for m in self._pattern.findall(text))

    def score_partial_token(self, token: str) -> float:
        """Bonus for a partial word that could still become a hotword."""
        if not self.hotwords or not token:
            return 0.0
        if token in self:
            # scaled so a full hotword's partial bonus ~ its completed bonus
            return self.weight * min(len(token), self._shortest)
        return 0.0
