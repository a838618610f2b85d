"""Host-side WER / CER (port of ``rnntransducer_tpu/train/metrics.py``).

Corpus-level, as torchmetrics' WordErrorRate / CharErrorRate: total edit
distance over total reference length, computed on the host from decoded
strings.
"""

from __future__ import annotations

from typing import List, Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance, O(len(ref) * len(hyp))."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def error_counts(preds: List[str], refs: List[str]) -> tuple:
    """(word_errs, word_total, char_errs, char_total) — the corpus-level
    sufficient statistics, so multi-host eval can sum counts across
    processes instead of averaging per-process rates (which would weight
    processes, not utterances)."""
    we = wt = ce = ct = 0
    for p, r in zip(preds, refs):
        rw, pw = r.split(), p.split()
        we += edit_distance(rw, pw)
        wt += len(rw)
        ce += edit_distance(list(r), list(p))
        ct += len(r)
    return we, wt, ce, ct


def word_error_rate(preds: List[str], refs: List[str]) -> float:
    we, wt, _, _ = error_counts(preds, refs)
    return we / max(wt, 1)


def char_error_rate(preds: List[str], refs: List[str]) -> float:
    _, _, ce, ct = error_counts(preds, refs)
    return ce / max(ct, 1)
