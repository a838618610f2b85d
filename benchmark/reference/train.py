"""A training step in plain PyTorch: features, the model, the RNN-T loss
(mean over the rows), the gradients, and AdamW (torch's decoupled form)
under the OneCycle cosine learning-rate schedule the configurations name.

``reference_steps`` follows the first steps of a run from the weights the
harness made: the loss of each step, the first step's gradient, and the
parameters after the last step."""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import augment
from benchmark.reference.frontend import int16_transfer, logmel
from benchmark.reference.loss import rnnt_nll
from benchmark.reference.model import Reference


def onecycle_lr(train: Mapping, count: int) -> float:
    """optax's cosine OneCycle at update ``count``, with the warmup a whole
    number of steps of at least one."""
    steps = max(int(train["max_steps"]), 2)
    warm = min(max(int(steps * train["warmup_ratio"]), 1), steps - 1)
    lr, div, final = train["learning_rate"], train["div_factor"], train["final_div_factor"]
    init = lr / div
    bounds = [0, int((warm + 0.5) / steps * steps), steps]
    values = [init, lr, lr / (div * final)]
    if count >= bounds[2]:
        return values[2]
    i = 0 if count < bounds[1] else 1
    pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
    start, end = values[i], values[i + 1]
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


class AdamW:
    """torch.optim.AdamW's update written out: decay p by lr * wd, then the
    bias-corrected Adam step with eps outside the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p = params
        self.wd, self.b1, self.b2, self.eps = wd, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def batch_loss(ref: Reference, cfg: Mapping, rows: Sequence[dict], device,
               int16: bool, masks: Optional[Mapping] = None) -> torch.Tensor:
    """Mean RNN-T loss of ``rows`` (dicts with float32 'wav' and int 'labels').
    The waves go through the int16 transfer first where the run ships int16
    PCM.  ``masks``: the step's dropout and SpecAugment masks
    (``reference.augment``), where the configuration trains with them."""
    audio = cfg["data"]["audio"]
    spec_keep, enc_keep, pred_keep, joint_keep = augment.split(masks, cfg)
    waves = [torch.from_numpy(int16_transfer(r["wav"]) if int16 else r["wav"])
             for r in rows]
    with torch.no_grad():
        feats, flen = logmel(waves, audio, device)
        feats = augment.spec_augment(feats, spec_keep, flen, audio)
    U = max(len(r["labels"]) for r in rows)
    labels = torch.zeros((len(rows), U), dtype=torch.int64)
    for i, r in enumerate(rows):
        labels[i, :len(r["labels"])] = torch.as_tensor(r["labels"])
    ulen = torch.tensor([len(r["labels"]) for r in rows], dtype=torch.int64)
    labels, ulen = labels.to(device), ulen.to(device)
    text_in = torch.cat([torch.zeros_like(labels[:, :1]), labels], 1)
    enc, elen = ref.encode(feats, flen, enc_keep)
    dec = ref.predict(text_in, ulen + 1, pred_keep)
    lpb, lpe = ref.lattice_logprobs(enc, dec, labels, joint_keep)
    return rnnt_nll(lpb, lpe, elen, ulen).mean()


def reference_steps(cfg: Mapping, params0: Mapping[str, torch.Tensor],
                    batches: Sequence[Sequence[dict]], device,
                    precision: str = "fp32",
                    masks: Optional[Sequence[Mapping]] = None) -> dict:
    """Follow ``len(batches)`` training steps from ``params0`` (left
    untouched), step k with ``masks[k]`` (the program's dropout and
    SpecAugment masks of that step, where the configuration trains with
    them).  Returns {'losses': [...], 'grad1': {name: norm},
    'change': {name: norm of p_last - p0}}."""
    train = cfg["train"]
    int16 = train.get("wav_transfer_dtype", "float32") == "int16"
    params = {k: v.detach().to(device, torch.float32, copy=True).requires_grad_(True)
              for k, v in params0.items()}
    opt = AdamW(params, train["weight_decay"])
    ref = Reference(cfg["model"], params, precision, remat=True)
    names = list(params)
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for step, rows in enumerate(batches):
        loss = batch_loss(ref, cfg, rows, device, int16,
                          None if masks is None else masks[step])
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        if step == 0:
            grad1 = {k: float(g.double().norm()) for k, g in zip(names, grads)}
        opt.step(dict(zip(names, grads)), onecycle_lr(train, step))
        del grads, loss
    change = {k: float((params[k].detach().double()
                        - params0[k].to(device).double()).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "change": change}


def readings(program: dict, reference: dict) -> Dict[str, float]:
    """The three numbers compared: the largest relative gap of a step's loss;
    by the worst leaf, the gap between the program's and the reference's
    norm of the first gradient, and of the parameters' change, each over the
    larger of that leaf's reference norm and the median leaf's.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    g_ref = reference["grad1"]
    med_g = float(np.median(list(g_ref.values())))

    def worst(prog, ref, keys):
        med = float(np.median([ref[k] for k in keys]))
        return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)

    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    return {"loss_rel": loss,
            "grad1_leaf": worst(program["grad1"], g_ref, list(g_ref)),
            "change_leaf": worst(program["change"], reference["change"], moving)}
