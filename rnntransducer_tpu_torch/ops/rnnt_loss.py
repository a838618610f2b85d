"""RNN-T loss (port of ``rnntransducer_tpu/ops/rnnt_loss.py``).

The lattice is swept by label column: within column u the recurrence

    alpha[t, u] = logaddexp(alpha[t-1, u] + bl[t-1, u], alpha[t, u-1] + lb[t, u-1])

is solved in closed form with an exclusive cumsum of the blank edges and a
running logsumexp (``ops.rnnt_kernels.sweep``: the CUDA kernel on the card,
its plain version on the CPU; the shift-then-cumsum ``exclusive_cumsum``
lives there too).  beta is the same sweep on the length-aware
flipped lattice; the alpha and beta sweeps of one loss go to the kernel as
one call over 2B lattices.  Gradients are the occupancy form, with FastEmit
scaling the label arcs by (1 + lambda):

    d/d bl[t,u] = -exp(alpha[t,u] + bl[t,u] + beta[t+1,u] - logZ)
    d/d lb[t,u] = -(1 + lambda) exp(alpha[t,u] + lb[t,u] + beta[t,u+1] - logZ)

The autograd function sits at the (bl, lb) level; the log-softmax and label
gather that produce bl/lb stay in plain torch ops, which autograd
differentiates back to the logits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rnntransducer_tpu_torch.ops import rnnt_kernels
from rnntransducer_tpu_torch.utils.precision import full_precision_matmul

NEG = -1e30  # large-negative stand-in for -inf (NaN-safe under arithmetic)


def _flip2d(x, t_len, u1_len):
    """Flip (B, T, U1) within per-sample valid extents along both axes."""
    B, T, U1 = x.shape
    ti = torch.arange(T, device=x.device)[None, :]
    tl = t_len.to(x.device, torch.int64).clamp(0, T)[:, None]
    tsrc = torch.where(ti < tl, tl - 1 - ti, ti)
    x = torch.gather(x, 1, tsrc[:, :, None].expand(B, T, U1))
    ui = torch.arange(U1, device=x.device)[None, :]
    ul = u1_len.to(x.device, torch.int64).clamp(0, U1)[:, None]
    usrc = torch.where(ui < ul, ul - 1 - ui, ui)
    return torch.gather(x, 2, usrc[:, None, :].expand(B, T, U1))


def _shift_up(x, dim, fill=NEG):
    """x shifted by -1 along dim (x[i] = x_in[i+1]), last slot = fill."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, 1]
    return F.pad(x.narrow(dim, 1, x.shape[dim] - 1), pad, value=fill)


def _alpha_beta(bl, lb, t_len, u_len):
    """(alpha, beta, logZ) of the compacted lattice; bl/lb (B, T, U+1)
    float32; beta includes the final-blank emission."""
    B, T, U1 = bl.shape
    bidx = torch.arange(B, device=bl.device)
    t_last = (t_len.to(bl.device, torch.int64) - 1).clamp(0, T - 1)
    u_last = u_len.to(bl.device, torch.int64).clamp(0, U1 - 1)
    final_bl = bl[bidx, t_last, u_last]

    # beta via graph reversal on the flipped lattice:
    #   beta_excl(flipped) = sweep(shifted flipped edges); beta = beta_excl + final_bl
    u1_len = u_last + 1
    be_rev = _shift_up(_flip2d(bl, t_len, u1_len), 1)
    le_rev = _shift_up(_flip2d(lb, t_len, u1_len), 2)
    swept = rnnt_kernels.sweep(torch.cat([bl, be_rev]), torch.cat([lb, le_rev]))
    alpha, beta_excl_f = swept[:B], swept[B:]
    logZ = alpha[bidx, t_last, u_last] + final_bl
    beta = _flip2d(beta_excl_f, t_len, u1_len) + final_bl[:, None, None]
    return alpha, beta, logZ


class RNNTCore(torch.autograd.Function):
    """Per-sample negative log-likelihood (B,) from compacted log-probs, with
    the occupancy backward (``rnnt_loss.py:143-200``).

    ``fastemit_lambda`` (FastEmit, arXiv:2010.11148): the backward scales the
    label-arc gradient by (1 + lambda); blank arcs and the forward value are
    unchanged.  0.0 = the plain loss."""

    @staticmethod
    def forward(ctx, bl, lb, t_len, u_len, fastemit_lambda: float = 0.0):
        alpha, beta, logZ = _alpha_beta(bl, lb, t_len, u_len)
        ctx.save_for_backward(bl, lb, t_len, u_len, alpha, beta, logZ)
        ctx.fastemit_lambda = fastemit_lambda
        return -logZ

    @staticmethod
    def backward(ctx, g):
        bl, lb, t_len, u_len, alpha, beta, logZ = ctx.saved_tensors
        B, T, U1 = bl.shape
        ti = torch.arange(T, device=bl.device)[None, :, None]
        ui = torch.arange(U1, device=bl.device)[None, None, :]
        tl = t_len.to(bl.device, torch.int64)[:, None, None]
        ul = u_len.to(bl.device, torch.int64)[:, None, None]
        valid = (ti < tl) & (ui <= ul)
        # beta outside the valid region holds finite flip garbage, which the
        # shifted reads below would pick up at t+1 == T_b / u+1 > U_b; mask first
        beta = torch.where(valid, beta, NEG)
        lz = logZ[:, None, None]

        # blank: (t,u) -> (t+1,u); the final blank at (T-1, U) exits the lattice
        beta_up = torch.where((ti == tl - 1) & (ui == ul), 0.0, _shift_up(beta, 1))
        g_bl = alpha + bl + beta_up - lz
        d_bl = -torch.exp(torch.where(valid, g_bl, NEG))

        # label: (t,u) -> (t,u+1), defined for u < U; FastEmit scales it
        g_lb = alpha + lb + _shift_up(beta, 2) - lz
        d_lb = -(1.0 + ctx.fastemit_lambda) * torch.exp(
            torch.where(valid & (ui < ul), g_lb, NEG))

        scale = g[:, None, None]
        return d_bl * scale, d_lb * scale, None, None, None


def _reduce(losses, reduction: str):
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def _padded_labels(labels, U1: int, blank: int):
    lab = labels.to(torch.int64)
    return F.pad(lab, (0, U1 - lab.shape[1]), value=blank)


def compact_lattice(logits, labels, blank: int = 0):
    """(B, T, U+1, V) raw logits + (B, U) labels -> (bl, lb): blank / label
    log-probs (B, T, U+1) in float32.  Label ids must lie in [0, V): the
    gather does not clamp them as JAX's does."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    bl = lp[..., blank]
    lab = _padded_labels(labels, logits.shape[2], blank)
    lb = torch.gather(lp, 3, lab[:, None, :, None].expand(*lp.shape[:3], 1))[..., 0]
    return bl, lb


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank: int = 0,
              reduction: str = "mean", fastemit_lambda: float = 0.0):
    """RNN-T loss of the (B, T, U+1, V) raw logits lattice; labels (B, U);
    lengths (B,).  bf16 logits are upcast to float32 for the log-softmax and
    the recursion."""
    bl, lb = compact_lattice(logits, labels, blank)
    losses = RNNTCore.apply(bl, lb, logit_lengths, label_lengths, fastemit_lambda)
    return _reduce(losses, reduction)


def rnnt_loss_fused(joint_fn, enc, dec, labels, enc_lengths, label_lengths,
                    blank: int = 0, reduction: str = "mean",
                    chunk_frames: int = 64, fastemit_lambda: float = 0.0):
    """The loss without the full (B, T, U+1, V) logits lattice: the joint,
    log-softmax and label gather run per T-chunk under activation
    checkpointing (the backward rebuilds one chunk at a time), emitting only
    the compacted (B, T, U+1) log-probs.  Same numbers as :func:`rnnt_loss`.

    joint_fn: (enc_chunk (B, Tc, De), dec (B, U+1, Dd)) -> (B, Tc, U+1, V)
    raw logits; it must take its parameters from its closure, not from
    module state that changes between the forward and the backward."""
    B, T, _ = enc.shape
    U1 = dec.shape[1]
    Tc = min(chunk_frames, T)
    nT = -(-T // Tc)
    if nT * Tc != T:
        enc = F.pad(enc, (0, 0, 0, nT * Tc - T))
    lab = _padded_labels(labels, U1, blank)

    def chunk(enc_chunk):
        lp = torch.log_softmax(joint_fn(enc_chunk, dec).float(), dim=-1)
        bl_c = lp[..., blank]
        lb_c = torch.gather(lp, 3, lab[:, None, :, None].expand(*lp.shape[:3], 1))
        return bl_c, lb_c[..., 0]

    parts = [checkpoint(chunk, enc[:, i * Tc:(i + 1) * Tc], use_reentrant=False)
             for i in range(nT)]
    bl = torch.cat([p[0] for p in parts], dim=1)[:, :T]
    lb = torch.cat([p[1] for p in parts], dim=1)[:, :T]
    losses = RNNTCore.apply(bl, lb, enc_lengths, label_lengths, fastemit_lambda)
    return _reduce(losses, reduction)


class _Fp32Bmm(torch.autograd.Function):
    """a @ b for float32 batches, forward and backward in full float32 (no
    TF32 whatever the global flag; the backward's GEMMs run after any scope
    around the forward has closed)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_precision_matmul():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with full_precision_matmul():
            ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
            gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def factored_compact_lattice(A, C, labels, blank: int = 0, shard=None):
    """GEMM-form compact lattice for the rank-decomposed concat joint.

    A (B, T, V): encoder logit factor; C (B, U+1, V): decoder factor (fc bias
    folded in), with logits[b, t, u] == A[b, t] + C[b, u].  Returns (bl, lb)
    as :func:`compact_lattice` does, without the (B, T, U+1, V) lattice:

        LSE[b,t,u] = maxA[b,t] + maxC[b,u] + log((EA @ EC^T)[b,t,u]),
        EA = exp(A - maxA),  EC = exp(C - maxC)

    The max shifts cancel in LSE, so they are detached and autograd gives
    the exact softmax backward.  Computed in full float32 (no TF32); the
    product is floored at the float32 tiny so that anti-aligned factor
    peaks stay finite.

    Under a ``parallel.mesh.VocabShard`` A and C hold this rank's columns
    [start, start + size) of V: the maxima are all-reduced with MAX, and
    each rank's part of EA @ EC^T, of the label terms and of the blank
    column (from the rank that holds it) is summed over the model group by
    ``reduce_from``, whose backward passes the cotangent through unchanged
    (every rank computes the same loss, so a sum there would multiply the
    fc grads by the group's width)."""
    A = A.float()
    C = C.float()
    U1, V = C.shape[1], A.shape[-1]
    if shard is None:
        def total(x):
            return x
        maxA, maxC = A.amax(-1).detach(), C.amax(-1).detach()
        lab = _padded_labels(labels, U1, blank)
        onehot = F.one_hot(lab, V).float()  # (B,U+1,V)
        blank_a, blank_c = A[..., blank], C[..., blank]
    else:
        from rnntransducer_tpu_torch.parallel.mesh import MODEL_AXIS, reduce_from
        mesh = shard.mesh

        def total(x):
            return reduce_from(x, mesh)
        maxA = mesh.all_reduce(A.detach().amax(-1), MODEL_AXIS, "max")
        maxC = mesh.all_reduce(C.detach().amax(-1), MODEL_AXIS, "max")
        lab = _padded_labels(labels, U1, blank) - shard.start
        here = ((lab >= 0) & (lab < V)).float()
        onehot = F.one_hot(lab.clamp(0, V - 1), V).float() * here[..., None]
        b = blank - shard.start
        blank_a, blank_c = ((A[..., b], C[..., b]) if 0 <= b < V else
                            (A.new_zeros(A.shape[:2]), C.new_zeros(C.shape[:2])))
        blank_a, blank_c = total(blank_a), total(blank_c)
    EA = torch.exp(A - maxA[..., None])
    EC = torch.exp(C - maxC[..., None])
    S = total(_Fp32Bmm.apply(EA, EC.transpose(1, 2)))
    S = S.clamp_min(float(np.finfo(np.float32).tiny))
    lse = maxA[:, :, None] + maxC[:, None, :] + torch.log(S)

    a_lab = total(_Fp32Bmm.apply(A, onehot.transpose(1, 2)))
    c_lab = total((C * onehot).sum(-1))

    bl = blank_a[:, :, None] + blank_c[:, None, :] - lse
    lb = a_lab + c_lab[:, None, :] - lse
    return bl, lb


def rnnt_loss_factored(A, C, labels, logit_lengths, label_lengths,
                       blank: int = 0, reduction: str = "mean",
                       fastemit_lambda: float = 0.0, shard=None):
    """RNN-T loss straight from the concat joint's (A, C) factors: a few
    (B, T, V)-sized GEMMs plus the (B, T, U+1) recursion, no lattice and no
    recomputation.  Under a vocabulary ``shard`` (A, C) are this rank's
    columns (:func:`factored_compact_lattice`); the V-free recursion runs
    alike on every rank of the model group."""
    bl, lb = factored_compact_lattice(A, C, labels, blank, shard)
    losses = RNNTCore.apply(bl, lb, logit_lengths, label_lengths, fastemit_lambda)
    return _reduce(losses, reduction)
