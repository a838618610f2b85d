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
then each part's dropout sites in the order its module states them (the
encoder's, the prediction network's, the joint's).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from benchmark.reference import parts


class MaskMismatch(ValueError):
    """The program's masks do not fit the step the configuration states."""


def sites(model: Mapping) -> Tuple[List[float], List[float], List[float]]:
    """The rate of each dropout mask a training step draws, in the program's
    call order, in the encoder, the prediction network and the joint: what
    each part's module (``reference.parts``) states."""
    enc, pred, joint = parts.of(model)
    return (enc.dropout_sites(model["transnet"]), pred.dropout_sites(model["prednet"]),
            joint.dropout_sites(model["jointnet"]))


def split(masks: Optional[Mapping], cfg: Mapping):
    """(SpecAugment keep mask or None, the encoder's, the prediction
    network's and the joint's dropout keep masks) of one step;
    ``MaskMismatch`` where their number is not what the configuration's
    step draws."""
    groups = sites(cfg["model"])
    n_drop = sum(len(g) for g in groups)
    spec_on = bool(cfg["data"]["audio"].get("spec_augment", False))
    if masks is None:
        if spec_on or n_drop:
            raise MaskMismatch("the configuration drops and masks; no masks were read back")
        return None, [], [], []
    drop, spec = list(masks.get("dropout", [])), list(masks.get("spec", []))
    if len(spec) != int(spec_on) or len(drop) != n_drop:
        raise MaskMismatch(f"read back {len(spec)} SpecAugment and {len(drop)} dropout "
                           f"masks; the step draws {int(spec_on)} and {n_drop}")
    out, i = [], 0
    for g in groups:
        out.append(drop[i:i + len(g)])
        i += len(g)
    return (spec[0] if spec else None), out[0], out[1], out[2]


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


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float,
            time_dims: Sequence[int] = (1,)) -> torch.Tensor:
    """Inverted dropout of ``x`` at ``rate`` on the kept elements of
    ``keep``, which has ``x``'s shape but may be longer on ``time_dims``
    (the program pads to its bucket; the first frames are used)."""
    ok = keep.dim() == x.dim() and all(
        k >= n if d in time_dims else k == n
        for d, (k, n) in enumerate(zip(keep.shape, x.shape)))
    if not ok:
        raise MaskMismatch(f"dropout mask {tuple(keep.shape)} for a tensor {tuple(x.shape)}")
    k = keep[tuple(slice(0, n) for n in x.shape)]
    return torch.where(k.to(x.device), x / (1.0 - rate), torch.zeros_like(x))


def share_gap(steps: Sequence[Optional[Mapping]], cfg: Mapping) -> float:
    """By the worst mask of the steps, the gap between its dropped share and
    its site's rate, over the rate; 1 where a step read back masks that do
    not fit (as a step that drops nothing reads), 0 where the configuration
    drops nothing."""
    rates = sites(cfg["model"])
    worst = 0.0
    for masks in steps:
        try:
            keeps = split(masks, cfg)[1:]
        except MaskMismatch:
            return 1.0
        for group, group_rates in zip(keeps, rates):
            for k, rate in zip(group, group_rates):
                dropped = 1.0 - float(k.float().mean())
                worst = max(worst, abs(dropped - rate) / rate)
    return worst
