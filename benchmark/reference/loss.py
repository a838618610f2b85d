"""The RNN-T loss (Graves 2012): the negative log-likelihood of the labels,
summed over every alignment of the (T, U+1) lattice, by the forward (alpha)
recursion in float64, differentiated by autograd.

alpha[0, 0] = 0; alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
alpha[t, u-1] + emit[t, u-1]); nll = -(alpha[T-1, U] + blank[T-1, U]).
Along u the recursion of one frame is a log-space linear recurrence,
computed with a cumulative sum and a log-cumulative-sum-exp, so one frame is
a handful of vector operations over (B, U+1)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def logprobs_of(logits, labels, blank):
    """Blank and label log-probabilities (b, T, U+1) / (b, T, U) of joint
    logits (b, T, U+1, V)."""
    lse = torch.logsumexp(logits, -1)
    lpb = logits[..., blank] - lse
    U = labels.shape[1]
    idx = labels[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    lpe = logits[:, :, :U].gather(-1, idx)[..., 0] - lse[:, :, :U]
    return lpb, lpe


def _chunk_logprobs(A, C, labels, blank):
    return logprobs_of(A[:, :, None, :] + C[:, None, :, :], labels, blank)


def in_row_blocks(chunk, enc, dec, labels, blank: int = 0, rows: int = 4):
    """``chunk(enc, dec, labels, blank) -> (lpb, lpe)`` over a few rows of
    the batch at a time, recomputed in the backward, so the (T, U+1, V)
    lattice of only those rows is ever held."""
    outs_b, outs_e = [], []
    for r in range(0, enc.shape[0], rows):
        args = (enc[r:r + rows], dec[r:r + rows], labels[r:r + rows])
        if torch.is_grad_enabled():
            lpb, lpe = checkpoint(chunk, *args, blank, use_reentrant=False)
        else:
            lpb, lpe = chunk(*args, blank)
        outs_b.append(lpb)
        outs_e.append(lpe)
    return torch.cat(outs_b), torch.cat(outs_e)


def lattice_logprobs(A, C, labels, blank: int = 0, rows: int = 4):
    """Blank and label log-probabilities (B, T, U+1) / (B, T, U) of the joint
    ``A[t] + C[u]`` (A (B, T, V), C (B, U+1, V)), in row blocks."""
    return in_row_blocks(_chunk_logprobs, A, C, labels, blank, rows)


def rnnt_nll(lpb, lpe, T_len, U_len):
    """(B,) negative log-likelihoods from the lattice log-probabilities and
    each row's frame and label counts."""
    lpb, lpe = lpb.double(), lpe.double()
    B, T, U1 = lpb.shape
    zero = lpb.new_zeros((B, 1))
    alpha = torch.cat([zero, torch.cumsum(lpe[:, 0], -1)], -1)
    for t in range(1, T):
        below = alpha + lpb[:, t - 1]
        E = torch.cat([zero, torch.cumsum(lpe[:, t], -1)], -1)
        new = E + torch.logcumsumexp(below - E, -1)
        alpha = torch.where((t < T_len)[:, None], new, alpha)
    rows = torch.arange(B, device=lpb.device)
    last = lpb[rows, (T_len - 1).clamp(min=0)]
    return -(alpha[rows, U_len] + last[rows, U_len])
