"""Debugging tools (port of ``rnntransducer_tpu/utils/debugging.py``):

* ``debug_nans(enable)``: fail fast where the first non-finite value
  appears, instead of reading garbage checkpoints later: autograd's anomaly
  detection for the backward, and a forward hook on every module that
  raises naming the first module whose output is non-finite;
* ``checked_rnnt_loss``: the RNN-T loss behind the JAX function's five
  invariant checks (lengths within bounds, label ids inside the
  vocabulary, a finite result), returning ``(error, loss)``.

The JAX module's ``force_interpret`` has no counterpart: a kernel wrapper
given a CUDA tensor launches its kernel or raises, never its plain version.
To step through a computation, call the plain versions (the
``*_reference`` functions) or give the wrappers CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["CheckError", "checked_rnnt_loss", "debug_nans"]

# the forward hook's handle while debug_nans is on
_nan_hook = None


def _non_finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_non_finite(o) for o in out)
    if isinstance(out, dict):
        return any(_non_finite(o) for o in out.values())
    return False


def _check_output(module, inputs, output):
    if _non_finite(output):
        raise FloatingPointError(
            f"debug_nans: non-finite output of module {type(module).__name__} "
            f"({module.extra_repr() or 'no arguments'})")


def debug_nans(enable: bool = True) -> None:
    """Turn the non-finite checks on or off: anomaly detection with NaN
    checks in the backward, and a forward hook on every ``nn.Module`` that
    raises ``FloatingPointError`` at the first module (innermost first)
    whose floating-point output holds a NaN or an infinity.  Every check
    waits for the device."""
    global _nan_hook
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable and _nan_hook is None:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(_check_output)
    elif not enable and _nan_hook is not None:
        _nan_hook.remove()
        _nan_hook = None


class CheckError:
    """A failed check of :func:`checked_rnnt_loss`: ``get()`` gives its
    message, ``throw()`` raises it."""

    def __init__(self, message: str):
        self.message = message

    def get(self) -> str:
        return self.message

    def throw(self):
        raise ValueError(self.message)

    def __repr__(self) -> str:
        return f"CheckError({self.message!r})"


def checked_rnnt_loss(logits, labels, logit_lengths, label_lengths,
                      blank: int = 0, reduction: str = "mean"):
    """``ops.rnnt_loss.rnnt_loss`` behind runtime invariant checks, with the
    JAX function's messages.  Returns ``(error, loss)``: ``error`` is None
    or the first failed check (raise it with ``error.throw()``).  The input
    checks come first, and when one fails the loss is not computed (an
    out-of-range length or label id would index outside the lattice):
    ``loss`` is then None.  Each check waits for the device."""
    from rnntransducer_tpu_torch.ops.rnnt_loss import rnnt_loss

    _, T, U1, V = logits.shape
    checks = (
        ((logit_lengths >= 1).all(), "logit_lengths must be >= 1"),
        ((logit_lengths <= T).all(), "logit_lengths exceed the time axis"),
        ((label_lengths <= U1 - 1).all(), "label_lengths exceed U (logits U+1 axis)"),
        ((label_lengths >= 0).all(), "negative label_lengths"),
        (((labels >= 0) & (labels < V)).all(),
         "label ids outside [0, vocab) — the loss gather would silently clamp "
         "them (vocab/tokenizer mismatch?)"),
    )
    for ok, message in checks:
        if not bool(ok):
            return CheckError(message), None
    loss = rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=blank,
                     reduction=reduction)
    error: Optional[CheckError] = None
    if not bool(torch.isfinite(loss.detach()).all()):
        error = CheckError("non-finite RNN-T loss")
    return error, loss
