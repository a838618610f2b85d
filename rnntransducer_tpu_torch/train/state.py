"""Train state and the training / eval steps (port of
``rnntransducer_tpu/train/state.py``).

* Mixed precision: master params stay float32 in the model; each forward
  casts every float param to the compute dtype (``cfg.train.precision``)
  and runs the model on the cast copies through ``torch.func.
  functional_call``, so gradients flow back to the float32 masters, as the
  JAX package's ``_cast`` does.  The RNN-T loss upcasts to float32.
* Gradient accumulation over contiguous microbatches, float32 grads.
* The batch holds precomputed features, or raw PCM (float32, or int16 plus
  a per-utterance scale) that :func:`device_frontend` turns into log-mel
  features on the device.  SpecAugment and dropout draw from the state's
  ``generator``, seeded with the seed folded with the rank, so each rank
  masks its own rows with its own masks; weight noise draws from
  ``noise_generator``, seeded with the seed alone, so every rank perturbs
  the replicated params alike, as the JAX package's single draw does.
* Across the ranks of a process group (``parallel/``) each rank holds its
  share of the global batch; the summed microbatch grads and the loss are
  all-reduced once per step, before the global norm, so the clip, the
  non-finite skip and the EMA see the same values on every rank.
* The default (factored) joint+loss path never builds the (B, T, U+1, V)
  lattice; ``combine="add"`` takes the fused per-chunk path and
  ``joint_chunk_frames=0`` the full lattice, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from rnntransducer_tpu_torch.config import AudioConfig, Config
from rnntransducer_tpu_torch.frontend.fused_frontend import logmel_fused
from rnntransducer_tpu_torch.frontend.specaugment import spec_augment
from rnntransducer_tpu_torch.models.transducer import RNNTransducer, build_model
from rnntransducer_tpu_torch.ops.rnnt_loss import (rnnt_loss, rnnt_loss_factored,
                                                   rnnt_loss_fused)
from rnntransducer_tpu_torch.parallel.distributed import rank
from rnntransducer_tpu_torch.parallel.mesh import all_reduce_mean
from rnntransducer_tpu_torch.train.optim import (clip_by_global_norm, global_norm,
                                                 make_schedule, make_train_optimizer)
from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.precision import train_compute_dtype


class _Bound(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.m = model

    def forward(self, fn, *args):
        return fn(self.m, *args)


def with_params(model: nn.Module, params: Mapping[str, torch.Tensor],
                fn: Callable, *args):
    """``fn(model, *args)`` with the model's parameters replaced by
    ``params`` (name -> tensor, as ``named_parameters``) for the call."""
    return torch.func.functional_call(
        _Bound(model), {"m." + k: v for k, v in params.items()}, (fn,) + args)


def rank_seed(seed: int, rank_: int) -> int:
    """The mask stream's seed of ``rank_``: ``seed`` itself on rank 0, so a
    single process draws the masks it always drew."""
    return (seed + rank_ * 0x9E3779B97F4A7C15) % 2 ** 63


class TrainState:
    """step; the model holding the float32 master params; the optimizer and
    its lr schedule; the generators of SpecAugment / dropout (per rank) and
    of weight noise (shared); the EMA shadow of the params
    (``cfg.train.ema_decay > 0``, else None).

    ``updates`` counts the optimizer updates actually applied: a step skipped
    for non-finite grads advances ``step`` but neither ``updates`` nor the
    optimizer's moments, as the JAX package keeps its whole optimizer state
    (schedule count included) on such a step."""

    def __init__(self, cfg: Config, model: RNNTransducer,
                 optimizer: torch.optim.Optimizer, generator: torch.Generator,
                 noise_generator: torch.Generator,
                 ema: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.schedule = make_schedule(cfg.train)
        self.generator = generator
        self.noise_generator = noise_generator
        self.ema = ema
        self.step = 0
        self.updates = 0

    @classmethod
    def create(cls, cfg: Config, device=None,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               seed: Optional[int] = None) -> "TrainState":
        """A fresh state on ``device`` (default CUDA; raises when CUDA is
        absent and no device is named).  Weights from ``state_dict``, else
        random from seed 0; the generators are seeded from ``seed``, else
        ``cfg.train.seed`` (the mask stream folded with this process's
        rank).  The optimizer is ZeRO-1 sharded over the process group's
        ranks under ``cfg.train.shard_optimizer_state``."""
        device = resolve_device(device)
        model = build_model(cfg, device, state_dict, trainable=True)
        optimizer = make_train_optimizer(cfg.train, cfg.model,
                                         list(model.named_parameters()))
        seed = cfg.train.seed if seed is None else seed
        generator = torch.Generator(device=device).manual_seed(rank_seed(seed, rank()))
        noise_generator = torch.Generator(device=device).manual_seed(seed)
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if cfg.train.ema_decay > 0 else None)
        return cls(cfg, model, optimizer, generator, noise_generator, ema)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def dequantize_wav(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Raw PCM of a batch as float32: peak-scaled int16 'wav' times its
    per-utterance 'wav_scale' (the half-size transfer form), or a float
    'wav' as it is."""
    wav = batch["wav"]
    if wav.dtype == torch.int16:
        wav = wav.to(torch.float32) * batch["wav_scale"][:, None]
    return wav


def device_frontend(audio_cfg: AudioConfig, wav: torch.Tensor,
                    wav_lengths: Optional[torch.Tensor]):
    """Log-mel features of raw PCM on its own device: the fused kernel on the
    card, its plain version on the CPU.  Every raw-PCM consumer (the train
    loss, eval) goes through here, so they featurise alike."""
    return logmel_fused(wav, audio_cfg, wav_lengths)


def loss_fn(model: RNNTransducer, cfg: Config, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator],
            deterministic: bool, reduction: str = "mean",
            noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """RNN-T loss of ``batch`` ('feats' (B, T, M) and 'feat_lengths', or raw
    PCM 'wav' (B, S) with 'wav_lengths' and, for int16, 'wav_scale'; plus
    'text_in' (B, U+1), 'text_lengths', 'targets' (B, U), 'target_lengths')
    under ``params`` (name -> float32 master).  ``deterministic=False``
    applies SpecAugment, weight noise and dropout, drawing from
    ``generator`` (weight noise from ``noise_generator`` where given)."""
    dtype = train_compute_dtype(cfg.train.precision)
    audio = cfg.data.audio
    if "feats" in batch:
        feats, feat_lengths = batch["feats"], batch["feat_lengths"]
    else:
        feats, feat_lengths = device_frontend(audio, dequantize_wav(batch),
                                              batch["wav_lengths"])
    if not deterministic and audio.spec_augment:
        feats = spec_augment(feats, generator, feat_lengths,
                             freq_para=audio.freq_mask_para,
                             time_para=audio.time_mask_para,
                             freq_cnt=audio.freq_mask_cnt,
                             time_cnt=audio.time_mask_cnt)
    p = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    std = cfg.train.weight_noise_std
    if not deterministic and std > 0:
        # variational weight noise (Graves 2012): fresh noise on every float
        # param per microbatch; grads are taken at the noisy point
        noise = generator if noise_generator is None else noise_generator
        p = {k: v + std * torch.randn(v.shape, dtype=v.dtype, device=v.device,
                                      generator=noise)
             if v.is_floating_point() else v for k, v in p.items()}
    gen = None if deterministic else generator
    feats = feats.to(dtype)
    blank = cfg.data.text.pad_token_id
    enc_lengths = cfg.model.transnet.output_lengths(feat_lengths)
    fastemit = cfg.train.fastemit_lambda
    text_in, text_lengths = batch["text_in"], batch["text_lengths"]

    def encode_predict(m):
        enc, _ = m.encode(feats, feat_lengths, generator=gen)
        dec, _ = m.predict(text_in, text_lengths, generator=gen)
        return enc, dec

    chunk_frames = cfg.train.joint_chunk_frames
    if chunk_frames > 0 and cfg.model.jointnet.combine == "concat":
        # factored GEMM form: no (T, U) lattice of any width, no recompute
        A, C = with_params(model, p, lambda m: m.joint_factors(*encode_predict(m)))
        return rnnt_loss_factored(A, C, batch["targets"], enc_lengths,
                                  batch["target_lengths"], blank=blank,
                                  reduction=reduction, fastemit_lambda=fastemit)
    if chunk_frames > 0:
        # fused per-chunk path (the additive joint does not factor); the
        # chunk rebuilds a (B, Tc, U+1, hidden) lattice, so bound Tc
        enc, dec = with_params(model, p, encode_predict)

        def joint_fn(e, d):
            return with_params(model, p, lambda m: m.joint_step(e, d))
        return rnnt_loss_fused(joint_fn, enc, dec, batch["targets"], enc_lengths,
                               batch["target_lengths"], blank=blank,
                               reduction=reduction,
                               chunk_frames=min(chunk_frames, 64),
                               fastemit_lambda=fastemit)
    logits = with_params(model, p, lambda m: m(feats, feat_lengths, text_in,
                                               text_lengths, generator=gen))
    return rnnt_loss(logits, batch["targets"], enc_lengths, batch["target_lengths"],
                     blank=blank, reduction=reduction, fastemit_lambda=fastemit)


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step over ``cfg.train.accumulate_grad_batches``
    contiguous microbatches of ``batch`` (this rank's rows of the global
    batch), updating ``state`` in place.  Returns {'loss' (the global mean),
    'grad_norm' (before clipping), 'nonfinite_grad'} as device tensors."""
    cfg = state.cfg
    accum = max(cfg.train.accumulate_grad_batches, 1)
    names, masters = zip(*state.model.named_parameters())
    params = dict(zip(names, masters))
    B = next(iter(batch.values())).shape[0]
    mb = B // accum
    loss = torch.zeros((), dtype=torch.float32, device=masters[0].device)
    grads = None
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss_i = loss_fn(state.model, cfg, params, part, state.generator,
                         deterministic=False, noise_generator=state.noise_generator)
        g_i = [g.float() for g in torch.autograd.grad(loss_i, masters)]
        grads = g_i if grads is None else [a + b for a, b in zip(grads, g_i)]
        loss = loss + loss_i.detach().float()
    if accum > 1:
        loss = loss / accum
        grads = [g / accum for g in grads]
    # the one all-reduce of the step (a no-op without a process group)
    *grads, loss = all_reduce_mean(grads + [loss.reshape(1)])
    loss = loss[0]

    grad_norm = global_norm(grads)
    nonfinite = ~torch.isfinite(grad_norm)
    if cfg.train.grad_clip_norm is not None:
        grads = clip_by_global_norm(grads, cfg.train.grad_clip_norm, grad_norm)
    if not (cfg.train.skip_nonfinite_grads and bool(nonfinite)):
        with torch.no_grad():
            for p, g in zip(masters, grads):
                p.grad = g
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.updates)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1
    if state.ema is not None:
        d = cfg.train.ema_decay
        with torch.no_grad():
            for n, p in zip(names, masters):
                state.ema[n].mul_(d).add_(p, alpha=1.0 - d)
    state.step += 1
    return {"loss": loss, "grad_norm": grad_norm,
            "nonfinite_grad": nonfinite.to(torch.int32)}


def histogram(x: torch.Tensor, bins: int = 64):
    """``jnp.histogram(x, bins)`` on x's own device: (counts (bins,) int64,
    edges (bins + 1,) float32).  The range is [min, max] (+-0.5 where they
    are equal), the edges ``linspace`` over it; a value goes to the bin whose
    left edge is the last one at or below it, the maximum to the last bin."""
    x = x.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    steps = torch.arange(bins + 1, device=x.device, dtype=torch.float32)
    edges = lo + steps * ((hi - lo) / bins)
    edges[-1] = hi
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts, edges


def watch_step(state: TrainState, batch: Mapping[str, torch.Tensor], bins: int = 64
               ) -> Dict[str, Dict[str, tuple]]:
    """Parameter and gradient histograms (as ``wandb.watch(model,
    log="all")``), reduced on the device: one forward and backward over the
    first of ``cfg.train.accumulate_grad_batches`` microbatches (a gradient
    over the whole batch would hold that many microbatches' activations),
    with SpecAugment, dropout and weight noise drawn from a generator of its
    own, so training's draws are untouched.  Each histogram is of one leaf
    of the JAX package's params tree, named by its flax path
    (``encoder/rnn/fwd_0/w_hh``; layers a scanned stack holds in one leaf are
    one histogram).  Returns ``{"params": {name: (counts, edges)}, "grads":
    {...}}`` of device tensors."""
    from rnntransducer_tpu_torch.utils.weights import flax_layout

    cfg = state.cfg
    accum = max(cfg.train.accumulate_grad_batches, 1)
    if accum > 1:
        batch = {k: v[: v.shape[0] // accum] for k, v in batch.items()}
    names, masters = zip(*state.model.named_parameters())
    params = dict(zip(names, masters))
    gen = torch.Generator(device=masters[0].device).manual_seed(
        state.generator.initial_seed() + 1 + state.step)
    loss = loss_fn(state.model, cfg, params, batch, gen, deterministic=False)
    grads = dict(zip(names, torch.autograd.grad(loss, masters)))
    leaves: Dict[str, list] = {}
    for path, key, _, _ in flax_layout(cfg.model):
        leaves.setdefault("/".join(path), []).append(key)
    return {group: {name: histogram(torch.cat([src[k].reshape(-1) for k in keys]), bins)
                    for name, keys in leaves.items()}
            for group, src in (("params", params), ("grads", grads))}


def eval_step(cfg: Config, model: RNNTransducer, batch: Mapping[str, torch.Tensor],
              reduction: str = "mean") -> torch.Tensor:
    """Validation loss under the model's own params: no SpecAugment, no
    dropout, no weight noise.  ``reduction="none"`` gives per-sample losses."""
    with torch.no_grad():
        return loss_fn(model, cfg, dict(model.named_parameters()), batch, None,
                       deterministic=True, reduction=reduction)


def learning_rate_at(cfg: Config, step: int) -> float:
    return float(make_schedule(cfg.train)(step))
