"""Dropout and SpecAugment in the reference, on the masks the program drew.

The masks are the one input the reference takes from the program: which
elements a step dropped and which bins and frames it masked are draws of the
program's generator, read back from the checked steps.  Everything else is
the reference's own: dropout is applied at the configuration's rate (kept
elements scaled by 1 / (1 - rate)), SpecAugment zeroes the masked bins.

The masks are checked by themselves before they are used: each dropout
mask's dropped share against the configuration's rate (``share_gap``), and
each SpecAugment mask's form: at most ``freq_mask_cnt`` bands of fewer than
``freq_mask_para`` bins and ``time_mask_cnt`` spans of fewer than
``time_mask_para`` frames, the spans inside the utterance's frames.

``masks`` of a step is ``{"dropout": [bool keep masks], "spec": [bool keep
mask (B, T, n_mels)]}``, in the order the program made them: SpecAugment,
the encoder's stack (inputs of layers 1..L-1), the prediction network's.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch


class MaskMismatch(ValueError):
    """The program's masks do not fit the step the configuration states."""


def _rates(model: Mapping) -> Tuple[float, float, int, int]:
    tn, pn = model["transnet"], model["prednet"]
    if tn.get("arch", "rnn") != "rnn" and tn.get("dropout", 0.0) > 0:
        raise MaskMismatch("the reference applies dropout to recurrent stacks only")
    enc = tn.get("dropout", 0.0) if tn["num_layers"] > 1 else 0.0
    pred = pn.get("dropout", 0.0) if pn["num_layers"] > 1 else 0.0
    return (enc, pred, tn["num_layers"] - 1 if enc > 0 else 0,
            pn["num_layers"] - 1 if pred > 0 else 0)


def expects_masks(cfg: Mapping) -> bool:
    """Whether a training step of ``cfg`` draws masks."""
    enc, pred, _, _ = _rates(cfg["model"])
    return bool(cfg["data"]["audio"].get("spec_augment", False)) or enc > 0 or pred > 0


def split(masks: Optional[Mapping], cfg: Mapping):
    """(SpecAugment keep mask or None, encoder keep masks, prediction
    network keep masks) of one step; ``MaskMismatch`` where their number
    is not what the configuration's step draws."""
    enc, pred, n_enc, n_pred = _rates(cfg["model"])
    spec_on = bool(cfg["data"]["audio"].get("spec_augment", False))
    if masks is None:
        if spec_on or n_enc or n_pred:
            raise MaskMismatch("the configuration drops and masks; no masks were read back")
        return None, [], []
    drop, spec = list(masks.get("dropout", [])), list(masks.get("spec", []))
    if len(spec) != int(spec_on) or len(drop) != n_enc + n_pred:
        raise MaskMismatch(f"read back {len(spec)} SpecAugment and {len(drop)} dropout "
                           f"masks; the step draws {int(spec_on)} and {n_enc + n_pred}")
    return (spec[0] if spec else None), drop[:n_enc], drop[n_enc:]


def spec_augment(feats: torch.Tensor, keep: Optional[torch.Tensor], lengths: torch.Tensor,
                 audio: Mapping) -> torch.Tensor:
    """``feats`` (B, T, M) with the masked bins zeroed, after checking the
    mask's form against ``audio``'s SpecAugment settings."""
    if keep is None:
        return feats
    B, T, M = feats.shape
    if keep.shape[0] != B or keep.shape[1] < T or keep.shape[2] != M:
        raise MaskMismatch(f"SpecAugment mask {tuple(keep.shape)} for features {(B, T, M)}")
    k = keep.to(feats.device)
    bins = ~k.any(1)                                   # (B, M) masked on every frame
    frames = ~k.any(2)                                 # (B, T') masked on every bin
    if not torch.equal(k, ~(bins[:, None, :] | frames[:, :, None])):
        raise MaskMismatch("SpecAugment mask is not bands of bins times spans of frames")
    if int(bins.sum(1).max()) > audio["freq_mask_cnt"] * audio["freq_mask_para"]:
        raise MaskMismatch("SpecAugment masks more bins than its bands can hold")
    if int(frames.sum(1).max()) > audio["time_mask_cnt"] * audio["time_mask_para"]:
        raise MaskMismatch("SpecAugment masks more frames than its spans can hold")
    past = torch.arange(frames.shape[1], device=k.device)[None] >= lengths.to(k.device)[:, None]
    if bool((frames & past).any()):
        raise MaskMismatch("SpecAugment masks frames past the utterance's end")
    return feats * k[:, :T].to(feats.dtype)


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` (B, T, D) at ``rate`` on the kept elements
    of ``keep`` (B, >= T, D)."""
    B, T, D = x.shape
    if keep.shape[0] != B or keep.shape[1] < T or keep.shape[2] != D:
        raise MaskMismatch(f"dropout mask {tuple(keep.shape)} for a tensor {(B, T, D)}")
    return torch.where(keep[:, :T].to(x.device), x / (1.0 - rate), torch.zeros_like(x))


def share_gap(steps: Sequence[Optional[Mapping]], cfg: Mapping) -> float:
    """By the worst mask of the steps, the gap between its dropped share and
    the configuration's rate, over the rate; 1 where a step read back masks
    that do not fit (as a step that drops nothing reads), 0 where the
    configuration drops nothing."""
    enc, pred, _, _ = _rates(cfg["model"])
    worst = 0.0
    for masks in steps:
        try:
            _, enc_keep, pred_keep = split(masks, cfg)
        except MaskMismatch:
            return 1.0
        for keeps, rate in ((enc_keep, enc), (pred_keep, pred)):
            for k in keeps:
                dropped = 1.0 - float(k.float().mean())
                worst = max(worst, abs(dropped - rate) / rate)
    return worst


def layer_masks(keeps: List[torch.Tensor], rate: float):
    """The function the reference's stacks call between layers: layer
    ``l`` >= 1 gets ``keeps[l - 1]``; no masks, no dropout."""
    if not keeps:
        return None
    return lambda layer, x: dropout(x, keeps[layer - 1], rate)
