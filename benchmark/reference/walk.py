"""Judging a greedy RNN-T decode by the reference's logits.

The served output of a greedy decode is its appended tokens and the encoder
frame of each.  The decode that produced them made one decision at every
(frame, symbol) step: a label, or blank (which moves to the next frame), up
to ``max_symbols`` labels a frame; a label equal to the last appended one is
fed to the prediction network but not appended (a hidden repeat).  The walk
follows the served output through the reference: at every decision the
reference's logits (fp32) are read, and the gap by which the decision's
token lies below the reference's best is noted.  Where the output leaves a
decision open (a hidden repeat or a blank), both are followed while their
gaps stay under ``cap``; the path kept is the one whose widest gap is least.
The reading is that widest gap: 0 where every decision was the reference's
own argmax, a rounding-sized number where near-ties went the other way, and
large where a token was not the model's.

``control_gaps`` reads, along that same path, the gap of the token that a
lower-precision reference puts first."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.model import Reference


class _Hyp:
    __slots__ = ("state", "C", "last", "j", "syms", "worst", "total", "fed", "decisions")

    def __init__(self, state, C, last, j, syms, worst, fed, decisions, total=0.0):
        self.state, self.C, self.last, self.j = state, C, last, j
        self.syms, self.worst, self.fed, self.decisions = syms, worst, fed, decisions
        self.total = total


def _step(ref: Reference, state, token: int, device):
    new, C = _steps(ref, [state], [token], device)
    return new[0], C[0]


def _steps(ref: Reference, states: list, tokens: List[int], device):
    """One prediction-network step for each (state, token) pair, as one
    batch: (the new states, their joint factors C as float64 rows)."""
    with torch.no_grad():
        batch = None
        if states[0] is not None:
            batch = [(torch.cat([s[layer][0] for s in states]),
                      torch.cat([s[layer][1] for s in states]))
                     for layer in range(len(states[0]))]
        dec, new = ref.predict_step(torch.tensor(tokens, device=device), batch)
        C = ref.dec_factor(dec).double().cpu().numpy()
    out = [[(h[i:i + 1], c[i:i + 1]) for h, c in new] for i in range(len(tokens))]
    return out, C


def walk(ref: Reference, A: np.ndarray, tokens: Sequence[int],
         times: Optional[Sequence[int]], max_symbols: int, cap: float, device,
         keep: int = 8, full: bool = False) -> Tuple[float, Optional[dict]]:
    """(widest gap, path) of the served ``tokens`` over the encoder factor
    ``A`` (T', V) of one utterance.  With ``times`` (each token's encoder
    frame) a token may only be emitted at its frame; without them the walk
    also follows where each token could have been emitted.  ``full``: the
    decode's output buffer filled up, so labels after the last served one
    were not appended; the walk ends at that label's frame.  Open decisions
    are followed while their gaps stay under ``cap``; of the paths, the
    ``keep`` whose gaps sum least go on (a path that took a wrong branch
    meets the model's choices at a growing distance).  ``path`` holds the
    decisions (frame, number of labels fed before it) and the labels fed;
    (inf, None) where no path stays under ``cap``."""
    blank = ref.blank
    n = len(tokens)
    frames = A.shape[0]
    if full and n and times is not None:
        frames = min(frames, int(times[-1]) + 1)
    # labels served at each frame from each position on: a frame's labels
    # and its hidden repeats share its max_symbols steps
    due_at = [0] * (n + 1)
    if times is not None:
        for j in range(n - 1, -1, -1):
            due_at[j] = 1 + (due_at[j + 1] if j + 1 < n and times[j + 1] == times[j] else 0)
    state, C0 = _step(ref, None, blank, device)
    hyps = [_Hyp(state, C0, blank, 0, 0, 0.0, [], [])]
    for t in range(frames):
        frontier, done = hyps, {}
        while frontier:
            grown = []
            for h in frontier:
                if times is not None and h.j < n and times[h.j] < t:
                    continue                     # a served token left behind
                if full and h.j == n and t == frames - 1:
                    _keep(done, h, h.worst, h.total)
                    continue                     # the buffer's end: not judged on
                pinned = times is not None and h.j < n and times[h.j] == t
                if pinned and h.syms + due_at[h.j] > max_symbols:
                    continue                     # the frame's labels no longer fit
                if h.syms == max_symbols:
                    if not pinned:
                        _keep(done, h, h.worst, h.total)
                    continue
                logit = A[t] + h.C
                best = float(logit.max())
                dec = h.decisions + [(t, len(h.fed))]
                if h.j < n and (pinned or times is None):
                    gap = best - float(logit[tokens[h.j]])
                    if gap <= cap:
                        grown.append((h, int(tokens[h.j]), h.j + 1, gap, dec))
                if not pinned:
                    gap = best - float(logit[blank])
                    if gap <= cap:
                        _keep(done, _Hyp(h.state, h.C, h.last, h.j, 0, 0.0, h.fed, dec),
                              max(h.worst, gap), h.total + gap)
                if h.last != blank and h.syms + 1 + (due_at[h.j] if pinned else 0) \
                        <= max_symbols:
                    gap = best - float(logit[h.last])
                    if gap <= cap:
                        grown.append((h, h.last, h.j, gap, dec))
            grown = sorted(grown, key=lambda g: g[0].total + g[3])[:keep]
            frontier = []
            if grown:
                states, Cs = _steps(ref, [g[0].state for g in grown],
                                    [g[1] for g in grown], device)
                for (h, tok, j, gap, dec), state, C in zip(grown, states, Cs):
                    frontier.append(_Hyp(state, C, tok, j, h.syms + 1, max(h.worst, gap),
                                         h.fed + [tok], dec, h.total + gap))
        hyps = [_Hyp(h.state, h.C, h.last, h.j, 0, h.worst, h.fed, h.decisions, h.total)
                for h in sorted(done.values(), key=lambda h: h.total)[:keep]]
        if not hyps:
            return float("inf"), None
    ends = [h for h in hyps if h.j == n]
    if not ends:
        return float("inf"), None
    h = min(ends, key=lambda h: h.worst)
    return h.worst, {"decisions": h.decisions, "fed": h.fed}


def _keep(done: dict, h: _Hyp, worst: float, total: float) -> None:
    """Keep ``h`` among the hypotheses done with a frame; two that fed the
    same labels are one state, and the one with the lesser worst gap
    stays."""
    h.worst, h.total = worst, total
    key = (h.j, tuple(h.fed))
    if key not in done or (worst, total) < (done[key].worst, done[key].total):
        done[key] = h


def control_gaps(ref32: Reference, ref_lo: Reference, A32: np.ndarray, A_lo: np.ndarray,
                 path: dict, device) -> float:
    """The widest gap, by the fp32 reference, of the token the lower
    precision reference ``ref_lo`` puts first at each decision of ``path``."""
    blank = ref32.blank
    seq = [blank] + list(path["fed"])
    Cs32: List[np.ndarray] = []
    Cs_lo: List[np.ndarray] = []
    s32 = s_lo = None
    for tok in seq:
        s32, c32 = _step(ref32, s32, tok, device)
        s_lo, c_lo = _step(ref_lo, s_lo, tok, device)
        Cs32.append(c32)
        Cs_lo.append(c_lo)
    worst = 0.0
    for t, k in path["decisions"]:
        l32 = A32[t] + Cs32[k]
        pick = int(np.argmax(A_lo[t] + Cs_lo[k]))
        worst = max(worst, float(l32.max() - l32[pick]))
    return worst
