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
  ``generator``, seeded with the seed folded with the data index, so each
  data index masks its own rows with its own masks, and the ranks of one
  model / stage / time row, which compute the same rows, draw the same
  masks; weight noise draws from ``noise_generator``, seeded with the seed
  alone, so every rank perturbs the params alike (a vocabulary slice by its
  slice of the whole draw), as the JAX package's single draw does.
* On a mesh (``parallel/``) each data index holds its share of the global
  batch; the summed microbatch grads and the loss are averaged over the
  data group once per step, before the global norm, so the clip, the
  non-finite skip and the EMA see the same values on every rank.  The
  model axis splits the joint fc's V rows (the factored loss reduces over
  V across the model group); the stage and time axes route the encoder
  through ``parallel.pipeline`` / ``parallel.wavefront``.  The encoder's
  recurrent grads are summed over the stage group (each layer's is
  non-zero on its own stage only); no grad is reduced over the model or
  time groups, whose ranks already hold equal grads of every leaf they
  share (the wavefront sums its stack's over time in its backward).
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
from rnntransducer_tpu_torch.parallel.mesh import (STAGE_AXIS, TIME_AXIS,
                                                   TP_LEAVES, Mesh, all_reduce_mean,
                                                   all_reduce_sum, gather_rows,
                                                   gather_vocab, mesh_of, vocab_slice)
from rnntransducer_tpu_torch.train.optim import (clip_by_global_norm, global_norm,
                                                 make_schedule, make_train_optimizer)
from rnntransducer_tpu_torch.utils.device import resolve_device
from rnntransducer_tpu_torch.utils.precision import train_compute_dtype
from rnntransducer_tpu_torch.utils.profiling import annotate

# the model parts' spans: of train_step's forward alone, not of the
# evaluation and watch steps that call loss_fn too
_FWD = "train/forward"


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


def rank_seed(seed: int, index: int) -> int:
    """The mask stream's seed of data index ``index``: ``seed`` itself at
    index 0, so a single process draws the masks it always drew."""
    return (seed + index * 0x9E3779B97F4A7C15) % 2 ** 63


class TrainState:
    """step; the model holding the float32 master params (under a model
    axis, this rank's rows of the joint fc); the optimizer and its lr
    schedule; the generators of SpecAugment / dropout (per data index) and
    of weight noise (shared); the EMA shadow of the params
    (``cfg.train.ema_decay > 0``, else None); the mesh.

    ``updates`` counts the optimizer updates actually applied: a step skipped
    for non-finite grads advances ``step`` but neither ``updates`` nor the
    optimizer's moments, as the JAX package keeps its whole optimizer state
    (schedule count included) on such a step."""

    def __init__(self, cfg: Config, model: RNNTransducer,
                 optimizer: torch.optim.Optimizer, generator: torch.Generator,
                 noise_generator: torch.Generator,
                 ema: Optional[Dict[str, torch.Tensor]], mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
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
               seed: Optional[int] = None, mesh: Optional[Mesh] = None) -> "TrainState":
        """A fresh state on ``device`` (default CUDA; raises when CUDA is
        absent and no device is named).  Weights from ``state_dict``, else
        random from seed 0; the generators are seeded from ``seed``, else
        ``cfg.train.seed`` (the mask stream folded with this rank's data
        index).  ``mesh`` defaults to the one ``cfg.train`` asks for
        (``parallel.mesh.mesh_of``, which raises the JAX package's errors
        where the world size does not fit it); under a model axis the model
        keeps this rank's rows of the joint fc.  The optimizer is ZeRO-1
        sharded over the data axis under ``cfg.train.shard_optimizer_state``."""
        device = resolve_device(device)
        mesh = mesh if mesh is not None else mesh_of(cfg.train)
        model = build_model(cfg, device, state_dict, trainable=True)
        shard = mesh.vocab_shard(cfg.model.jointnet.num_classes)
        if shard is not None:
            model.joint.keep_vocab_rows(shard.start, shard.size)
        optimizer = make_train_optimizer(cfg.train, cfg.model,
                                         list(model.named_parameters()), mesh)
        seed = cfg.train.seed if seed is None else seed
        generator = torch.Generator(device=device).manual_seed(
            rank_seed(seed, mesh.data_index))
        noise_generator = torch.Generator(device=device).manual_seed(seed)
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if cfg.train.ema_decay > 0 else None)
        return cls(cfg, model, optimizer, generator, noise_generator, ema, mesh)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def vocab_shard(self):
        """This rank's rows of the joint fc (None without a model axis)."""
        return self.mesh.vocab_shard(self.cfg.model.jointnet.num_classes)

    def whole(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tensors`` (keyed by param name, in this rank's layout) in the
        single-device layout: the fc rows gathered over the model group (a
        collective there: every rank of the group calls it)."""
        shard = self.vocab_shard
        if shard is None:
            return dict(tensors)
        return {k: gather_vocab(v, shard) if k in TP_LEAVES else v
                for k, v in tensors.items()}

    def own(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tensors`` in the single-device layout cut to this rank's: its
        rows of the fc."""
        shard = self.vocab_shard
        return {k: vocab_slice(v, shard) if k in TP_LEAVES else v
                for k, v in tensors.items()}


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


def _parallel_encode(cfg: Config, mesh: Mesh, p: Mapping[str, torch.Tensor], feats,
                     feat_lengths, generator: Optional[torch.Generator]):
    """The encoder through the GPipe stage pipeline (``parallel/pipeline.py``)
    or the time-sharded wavefront (``parallel/wavefront.py``) over the
    mesh's schedule axis (the JAX package's ``_parallel_encode``).  The
    data and model axes are untouched: every rank of the schedule's group
    computes the same rows and gets the same encoder output."""
    from rnntransducer_tpu_torch.parallel.pipeline import pipeline_encode
    from rnntransducer_tpu_torch.parallel.wavefront import (pad_time_to_multiple,
                                                            wavefront_encode)

    tn = cfg.model.transnet
    if tn.arch != "rnn":
        raise ValueError(
            "pipeline_stages/sequence_parallel cover the RNN encoder family "
            f"only (arch={tn.arch!r}); the Conformer is all-GEMM — shard it "
            "with tensor/data parallelism instead")
    enc = {k[len("encoder."):]: v for k, v in p.items() if k.startswith("encoder.")}
    drop = 0.0 if generator is None else tn.dropout
    if cfg.train.pipeline_stages > 1:
        if STAGE_AXIS not in mesh.axis_names:
            raise RuntimeError(
                f"pipeline_stages={cfg.train.pipeline_stages} needs a mesh with a "
                "'stage' axis (make_mesh(pipeline_stages=...); the Trainer does this)")
        M = cfg.train.pipeline_microbatches or cfg.train.pipeline_stages
        return pipeline_encode(enc, tn, feats, feat_lengths, mesh, M, dropout=drop,
                               generator=generator)
    if TIME_AXIS not in mesh.axis_names:
        raise RuntimeError(
            f"sequence_parallel={cfg.train.sequence_parallel} needs a mesh with a "
            "'time' axis (make_mesh(sequence_parallel=...); the Trainer does this)")
    T = feats.shape[1]
    x = pad_time_to_multiple(feats, mesh.size(TIME_AXIS))
    out, _ = wavefront_encode(enc, tn, x, feat_lengths, mesh, dropout=drop,
                              generator=generator)
    return out[:, :T]


def loss_fn(model: RNNTransducer, cfg: Config, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator],
            deterministic: bool, reduction: str = "mean",
            noise_generator: Optional[torch.Generator] = None,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """RNN-T loss of ``batch`` ('feats' (B, T, M) and 'feat_lengths', or raw
    PCM 'wav' (B, S) with 'wav_lengths' and, for int16, 'wav_scale'; plus
    'text_in' (B, U+1), 'text_lengths', 'targets' (B, U), 'target_lengths')
    under ``params`` (name -> float32 master).  ``deterministic=False``
    applies SpecAugment, weight noise and dropout, drawing from
    ``generator`` (weight noise from ``noise_generator`` where given).
    Under ``mesh`` the params hold this rank's rows of the joint fc where
    it has a model axis, and the encoder runs on the pipeline or the
    wavefront where ``cfg.train`` asks for one; every rank of a model,
    stage or time row returns the same loss of the same rows."""
    dtype = train_compute_dtype(cfg.train.precision)
    audio = cfg.data.audio
    shard = None if mesh is None else mesh.vocab_shard(cfg.model.jointnet.num_classes)
    pp_sp = cfg.train.pipeline_stages > 1 or cfg.train.sequence_parallel > 1
    text_in, text_lengths = batch["text_in"], batch["text_lengths"]
    dev = text_in.device
    with annotate("train/frontend", dev, _FWD):
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
        # param per microbatch; grads are taken at the noisy point.  A
        # vocabulary slice takes its rows of the whole draw.
        noise = generator if noise_generator is None else noise_generator

        def draw(k, v):
            shape = (shard.total,) + tuple(v.shape[1:]) if (
                shard is not None and k in TP_LEAVES) else v.shape
            n = torch.randn(shape, dtype=v.dtype, device=v.device, generator=noise)
            return v + std * (vocab_slice(n, shard) if shape != v.shape else n)
        p = {k: draw(k, v) if v.is_floating_point() else v for k, v in p.items()}
    gen = None if deterministic else generator
    feats = feats.to(dtype)
    blank = cfg.data.text.pad_token_id
    enc_lengths = cfg.model.transnet.output_lengths(feat_lengths)
    fastemit = cfg.train.fastemit_lambda

    def encode_predict(m):
        with annotate("train/encoder", dev, _FWD):
            if pp_sp:
                enc = _parallel_encode(cfg, mesh, p, feats, feat_lengths, gen)
            else:
                enc, _ = m.encode(feats, feat_lengths, generator=gen)
        with annotate("train/prednet", dev, _FWD):
            dec, _ = m.predict(text_in, text_lengths, generator=gen)
        return enc, dec

    chunk_frames = cfg.train.joint_chunk_frames
    if chunk_frames > 0 and cfg.model.jointnet.combine == "concat":
        # factored GEMM form: no (T, U) lattice of any width, no recompute;
        # under a model axis each rank takes its V columns
        def factored(m):
            enc, dec = encode_predict(m)
            with annotate("train/joint_loss", dev, _FWD):
                A, C = m.joint_factors(enc, dec, shard)
                return rnnt_loss_factored(A, C, batch["targets"], enc_lengths,
                                          batch["target_lengths"], blank=blank,
                                          reduction=reduction, fastemit_lambda=fastemit,
                                          shard=shard)
        return with_params(model, p, factored)
    if shard is not None:
        # the lattice paths take the whole fc, gathered (each rank keeps its
        # rows of the grads)
        p = {k: gather_rows(v, shard) if k in TP_LEAVES else v for k, v in p.items()}
    if chunk_frames > 0:
        # fused per-chunk path (the additive joint does not factor); the
        # chunk rebuilds a (B, Tc, U+1, hidden) lattice, so bound Tc
        enc, dec = with_params(model, p, encode_predict)

        def joint_fn(e, d):
            return with_params(model, p, lambda m: m.joint_step(e, d))
        with annotate("train/joint_loss", dev, _FWD):
            return rnnt_loss_fused(joint_fn, enc, dec, batch["targets"], enc_lengths,
                                   batch["target_lengths"], blank=blank,
                                   reduction=reduction,
                                   chunk_frames=min(chunk_frames, 64),
                                   fastemit_lambda=fastemit)
    if pp_sp:
        raise ValueError(
            "pipeline_stages/sequence_parallel need a factored or fused "
            "joint+loss path (train.joint_chunk_frames > 0 — the "
            "default); the unfused full-lattice path does not route the "
            "encoder separately")

    def unfused(m):
        enc, dec = encode_predict(m)
        with annotate("train/joint_loss", dev, _FWD):
            return rnnt_loss(m.joint_lattice(enc, dec), batch["targets"], enc_lengths,
                             batch["target_lengths"], blank=blank, reduction=reduction,
                             fastemit_lambda=fastemit)
    return with_params(model, p, unfused)


def _grads(loss: torch.Tensor, mesh: Mesh, names, masters) -> list:
    """float32 grads of ``loss`` for every master.  On a stage axis another
    stage's encoder layers are not reached and get zeros; any other leaf the
    loss does not reach is an error, as on every other mesh."""
    staged = mesh.size(STAGE_AXIS) > 1
    grads = torch.autograd.grad(loss, masters, allow_unused=staged)
    if staged:
        grads = [torch.zeros_like(m) if g is None and n.startswith("encoder.rnn.") else g
                 for n, m, g in zip(names, masters, grads)]
        missing = [n for n, g in zip(names, grads) if g is None]
        if missing:
            raise RuntimeError(f"the loss does not reach {missing}")
    return [g.float() for g in grads]


def _stage_sum(mesh: Mesh, names, grads) -> None:
    """Sum the encoder's recurrent grads over the stage group, in place: each
    layer's is non-zero on the one stage that runs it."""
    if mesh.size(STAGE_AXIS) > 1:
        all_reduce_sum([g for n, g in zip(names, grads) if n.startswith("encoder.rnn.")],
                       mesh.group(STAGE_AXIS))


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step over ``cfg.train.accumulate_grad_batches``
    contiguous microbatches of ``batch`` (this rank's rows of the global
    batch), updating ``state`` in place.  Returns {'loss' (the global mean),
    'grad_norm' (before clipping), 'nonfinite_grad'} as device tensors."""
    names, masters = zip(*state.model.named_parameters())
    with annotate("train/step", masters[0].device):
        return _train_step(state, batch, names, masters)


def _train_step(state: TrainState, batch: Mapping[str, torch.Tensor], names, masters
                ) -> Dict[str, torch.Tensor]:
    cfg = state.cfg
    mesh = state.mesh
    dev = masters[0].device
    accum = max(cfg.train.accumulate_grad_batches, 1)
    params = dict(zip(names, masters))
    B = next(iter(batch.values())).shape[0]
    mb = B // accum
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = None
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        with annotate(_FWD, dev):
            loss_i = loss_fn(state.model, cfg, params, part, state.generator,
                             deterministic=False, noise_generator=state.noise_generator,
                             mesh=mesh)
        with annotate("train/backward", dev):
            g_i = _grads(loss_i, mesh, names, masters)
            grads = g_i if grads is None else [a + b for a, b in zip(grads, g_i)]
        loss = loss + loss_i.detach().float()
    if accum > 1:
        loss = loss / accum
        grads = [g / accum for g in grads]
    with annotate("train/allreduce", dev):
        _stage_sum(mesh, names, grads)
        # the one all-reduce of the step over the data group (a no-op without one)
        *grads, loss = all_reduce_mean(grads + [loss.reshape(1)], mesh)
        loss = loss[0]

    with annotate("train/optimizer", dev):
        grad_norm = global_norm(grads, [i for i, n in enumerate(names) if n in TP_LEAVES],
                                mesh)
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
    {...}}`` of device tensors.  On a mesh with model, stage or time axes
    every rank of the data row calls it together (its collectives span
    them): the histograms are of the whole params and grads."""
    from rnntransducer_tpu_torch.utils.weights import flax_layout

    cfg = state.cfg
    accum = max(cfg.train.accumulate_grad_batches, 1)
    if accum > 1:
        batch = {k: v[: v.shape[0] // accum] for k, v in batch.items()}
    names, masters = zip(*state.model.named_parameters())
    params = dict(zip(names, masters))
    gen = torch.Generator(device=masters[0].device).manual_seed(
        state.generator.initial_seed() + 1 + state.step)
    loss = loss_fn(state.model, cfg, params, batch, gen, deterministic=False,
                   mesh=state.mesh)
    grad_list = _grads(loss, state.mesh, names, masters)
    _stage_sum(state.mesh, names, grad_list)
    grads = state.whole(dict(zip(names, grad_list)))
    params = state.whole({k: v.detach() for k, v in params.items()})
    leaves: Dict[str, list] = {}
    for path, key, _, _ in flax_layout(cfg.model):
        leaves.setdefault("/".join(path), []).append(key)
    return {group: {name: histogram(torch.cat([src[k].reshape(-1) for k in keys]), bins)
                    for name, keys in leaves.items()}
            for group, src in (("params", params), ("grads", grads))}


def eval_step(cfg: Config, model: RNNTransducer, batch: Mapping[str, torch.Tensor],
              reduction: str = "mean", mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Validation loss under the model's own params: no SpecAugment, no
    dropout, no weight noise.  ``reduction="none"`` gives per-sample losses.
    ``mesh``: as :func:`loss_fn` (a model holding its rank's fc rows, the
    encoder's schedule)."""
    with torch.no_grad():
        return loss_fn(model, cfg, dict(model.named_parameters()), batch, None,
                       deterministic=True, reduction=reduction, mesh=mesh)


def learning_rate_at(cfg: Config, step: int) -> float:
    return float(make_schedule(cfg.train)(step))
