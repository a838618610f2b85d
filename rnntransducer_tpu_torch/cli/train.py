"""Training CLI of the port: the flags and config of the JAX package's
``train.py``, run by the port's ``Trainer``, one process per CUDA device.

Examples:
  # smoke-train on synthetic data on the card
  python -m rnntransducer_tpu_torch.cli.train --synthetic 256 --max_steps 20 \\
      --checkpoint_dir /tmp/ckpt

  # the same on the CPU (the kernels' plain versions)
  python -m rnntransducer_tpu_torch.cli.train --synthetic 16 --max_steps 2 \\
      --device cpu --checkpoint_dir /tmp/ckpt

  # from a corpus: raw shards (cli.prepare_manifest), prepared into log-mel
  # shards under --pl_data_dir on the host the first time (process 0 alone;
  # the others wait for its _PREPARED marker), then trained on the card
  python -m rnntransducer_tpu_torch.cli.train --config configs/base.json \\
      --hf_data_dirs /data/raw --pl_data_dir /data/logmel --num_shards 20 \\
      --checkpoint_dir ckpts --max_steps 100000

  # train on log-mel Arrow shards prepared before (needs ``datasets``)
  python -m rnntransducer_tpu_torch.cli.train --config configs/base.json \\
      --pl_data_dir /data/logmel --checkpoint_dir ckpts --max_steps 100000

  # data parallel on the 8 cards of a node: torchrun starts one process per
  # card (each on cuda:<LOCAL_RANK>); the global batch is 8 x the per-device
  # batch, and the ranks compute what one process computes on it
  python -m torch.distributed.run --nproc_per_node 8 \\
      -m rnntransducer_tpu_torch.cli.train --synthetic 4096 --max_steps 100 \\
      --checkpoint_dir /tmp/ckpt [--shard_optimizer_state]

  # or start each process by hand (2 hosts x 1 card here)
  python -m rnntransducer_tpu_torch.cli.train --coordinator_address host0:1234 \\
      --num_processes 2 --process_id 0 ...

  # model parallel: ``--model_parallel 2`` splits the joint's vocabulary
  # over pairs of ranks; a --config whose train section sets
  # pipeline_stages (with pipeline_microbatches) or sequence_parallel runs
  # the encoder on the GPipe pipeline or the time wavefront; every extra axis
  # divides the world size, the rest is the data axis (here on the CPU)
  python -m torch.distributed.run --nproc_per_node 2 \
      -m rnntransducer_tpu_torch.cli.train --device cpu --config cfg.json

The Pallas / XLA loss-backend flag of ``train.py`` is accepted and raises:
the port's loss has one backend (the sweep kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from rnntransducer_tpu_torch.config import Config

SPLITS = ("train", "dev", "eval_clean", "eval_other")
PREPARE_POLL_S = 10         # how often a waiting process looks for _PREPARED
PREPARE_LOG_EVERY_S = 600   # and how often it says that it still waits


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config (the JAX package's schema)")
    p.add_argument("--vocab_path", type=str, default=None)
    p.add_argument("--hf_data_dirs", type=str, nargs="*", default=None,
                   help="raw PCM shard roots to prepare into log-mel shards "
                        "under --pl_data_dir (once: the _PREPARED marker)")
    p.add_argument("--pl_data_dir", type=str, default=None,
                   help="preprocessed log-mel shard root")
    p.add_argument("--num_shards", type=int, default=20,
                   help="log-mel shards of the train split (1 for the others)")
    p.add_argument("--num_proc", type=int, default=None,
                   help="host processes of the log-mel preparation")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances instead of real data")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--warmup_ratio", type=float, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--per_device_train_batch_size", type=int, default=None)
    p.add_argument("--per_device_eval_batch_size", type=int, default=None)
    p.add_argument("--accumulate_grad_batches", type=int, default=None)
    p.add_argument("--model_parallel", type=int, default=None,
                   help="the model axis: the joint fc's vocabulary over this many ranks")
    p.add_argument("--shard_optimizer_state", action="store_true", default=None,
                   help="ZeRO-1: split the AdamW / lion / SGD moments over the ranks")
    p.add_argument("--precision", type=str, default=None, choices=["bf16", "fp32"])
    p.add_argument("--optimizer", type=str, default=None,
                   choices=["adamw", "adafactor", "lion", "sgd"],
                   help="adamw and sgd are ported; adafactor and lion raise")
    p.add_argument("--lr_schedule", type=str, default=None,
                   choices=["onecycle", "cosine", "linear", "constant"])
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA shadow of the params (0 = off)")
    p.add_argument("--fastemit_lambda", type=float, default=None)
    p.add_argument("--weight_noise_std", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--val_every_steps", type=int, default=None)
    p.add_argument("--log_every_steps", type=int, default=None)
    p.add_argument("--watch_every_steps", type=int, default=None,
                   help="param/grad histograms every N steps (0 = off)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--loss_backend", type=str, default="auto",
                   choices=["auto", "pallas", "xla", "pallas_interpret"],
                   help="only auto: the port's loss runs on its sweep kernel")
    p.add_argument("--eval_only", action="store_true",
                   help="restore the best checkpoint and evaluate instead of training")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-15 here "
                        "(trace_<pid>_<ms>.json), and beside it the totals of the "
                        "step's spans (spans_<pid>_<ms>.json): for each of "
                        "train/step, train/forward, train/frontend, train/encoder, "
                        "train/prednet, train/joint_loss, train/backward, "
                        "train/allreduce, train/optimizer and data/prefetch_wait "
                        "its count, host_s, device_s and self_device_s (seconds "
                        "summed over the window), and the counts of data/batches "
                        "and data/prefetch_empty; the profile_written log line "
                        "gives train/step_ms (device ms per step) and "
                        "data/prefetch_wait_ms (host ms per step)")
    p.add_argument("--debug_nans", action="store_true",
                   help="fail at the first non-finite value: autograd anomaly "
                        "detection and forward hooks (utils.debugging.debug_nans)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda:<LOCAL_RANK>, or cuda; raises "
                        "without a card)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0's rendezvous (multi-process; torchrun's "
                        "environment is read without it)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def build_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    overrides = {k: getattr(args, k) for k in (
        "learning_rate", "weight_decay", "warmup_ratio", "max_steps",
        "per_device_train_batch_size", "per_device_eval_batch_size",
        "accumulate_grad_batches", "model_parallel", "shard_optimizer_state",
        "precision", "optimizer", "lr_schedule", "ema_decay", "fastemit_lambda",
        "weight_noise_std", "seed", "val_every_steps", "log_every_steps",
        "watch_every_steps", "checkpoint_dir")
        if getattr(args, k) is not None}
    train = dataclasses.replace(cfg.train, **overrides)
    return dataclasses.replace(cfg, train=train,
                               vocab_path=args.vocab_path or cfg.vocab_path)


def _check_flags(args) -> None:
    if args.loss_backend != "auto":
        raise NotImplementedError(
            f"--loss_backend {args.loss_backend}: the port's RNN-T loss has one "
            "backend, its sweep kernel (the plain version on the CPU)")


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    _check_flags(args)

    from rnntransducer_tpu_torch import parallel
    from rnntransducer_tpu_torch.parallel.mesh import mesh_shape
    from rnntransducer_tpu_torch.utils.debugging import debug_nans
    from rnntransducer_tpu_torch.utils.device import resolve_device

    device = args.device
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(device)
    topology = parallel.initialize(args.coordinator_address, args.num_processes,
                                   args.process_id, device=device)
    try:
        # the JAX package's refusals of a mesh the world size does not fit,
        # before any data is read
        mesh_shape(cfg.train.model_parallel, cfg.train.pipeline_stages,
                   cfg.train.sequence_parallel, topology["process_count"])
    except ValueError:
        parallel.shutdown()
        raise
    if args.debug_nans:
        debug_nans(True)
    try:
        return _run(args, cfg, device, topology)
    finally:
        if args.debug_nans:
            debug_nans(False)
        parallel.shutdown()


def prepare_shards(args, cfg, process_index: int) -> None:
    """Prepare ``--hf_data_dirs``' raw shards into log-mel shards under
    ``--pl_data_dir``, every split it has (train in ``--num_shards``
    shards, the others in 1), once: process 0 prepares and then writes the
    all-splits ``_PREPARED`` marker; every other process polls for the
    marker.  The wait is a poll and not a collective, because preparing a
    large corpus takes hours, past any process-group timeout.  The marker
    covers every split, so no process starts loading the dev shards while
    process 0 still writes them."""
    from rnntransducer_tpu_torch.data.dataset import prepare_logmel_dataset

    done_marker = os.path.join(args.pl_data_dir, "_PREPARED")
    if process_index == 0:
        if os.path.exists(done_marker):
            return
        for split in SPLITS:
            try:
                prepare_logmel_dataset(
                    args.hf_data_dirs, args.pl_data_dir, split, cfg.data.audio,
                    num_shards=args.num_shards if split == "train" else 1,
                    num_proc=args.num_proc or 1)
            except FileNotFoundError:
                print(f"[prepare] no source for split '{split}', skipping")
        os.makedirs(args.pl_data_dir, exist_ok=True)
        with open(done_marker, "w") as f:
            f.write("ok\n")
        return
    waited = 0
    if not os.path.exists(done_marker):
        print(f"[prepare] process {process_index} waits on process 0 for "
              f"{done_marker}", flush=True)
    while not os.path.exists(done_marker):
        time.sleep(PREPARE_POLL_S)
        waited += PREPARE_POLL_S
        if waited % PREPARE_LOG_EVERY_S == 0:  # a crashed process 0 shows here
            print(f"[prepare] waiting on process 0 ({waited // 60} min): "
                  f"{done_marker}", flush=True)


def _run(args, cfg, device, topology):
    from rnntransducer_tpu_torch.data.dataset import (ArrowAudioDataset,
                                                      SyntheticAudioDataset)
    from rnntransducer_tpu_torch.train.loop import Trainer

    lead = topology["process_index"] == 0
    if args.synthetic:
        train_ds = SyntheticAudioDataset(
            args.synthetic, cfg.data.audio,
            vocab_size=cfg.model.jointnet.num_classes, seed=cfg.train.seed)
        val_ds = SyntheticAudioDataset(
            max(args.synthetic // 8, 2), cfg.data.audio,
            vocab_size=cfg.model.jointnet.num_classes, seed=cfg.train.seed + 1)
    else:
        if not args.pl_data_dir:
            raise SystemExit("--pl_data_dir (or --synthetic N) required")
        if args.hf_data_dirs:
            prepare_shards(args, cfg, topology["process_index"])
        train_ds = ArrowAudioDataset([args.pl_data_dir], "train")
        val_ds = ArrowAudioDataset([args.pl_data_dir], "dev")

    trainer = Trainer(cfg, train_ds, val_dataset=val_ds, device=device,
                      profile_dir=args.profile_dir)
    if args.eval_only:
        trainer.ckpt.restore(trainer.state, step=trainer.ckpt.best_or_latest_step())
        tests = {}
        if args.synthetic:
            tests["synthetic"] = val_ds
        else:
            for split in ("eval_clean", "eval_other"):
                try:
                    tests[split] = ArrowAudioDataset([args.pl_data_dir], split)
                except FileNotFoundError:
                    print(f"[eval] no shards for '{split}', skipping")
        results = trainer.test(tests)
        for name, r in results.items():
            if lead:
                print(f"{name}: loss={r['loss']:.4f} wer={r['wer']:.4f} "
                      f"cer={r['cer']:.4f}")
        return results
    state = trainer.fit(resume=args.resume)
    print(f"rank {topology['process_index']} of {topology['process_count']}: done at "
          f"step {int(state.step)}; checkpoints in {cfg.train.checkpoint_dir}")
    return state


if __name__ == "__main__":
    main()
