"""Typed configuration tree, the PyTorch port's own copy of
``rnntransducer_tpu/config.py``.

The dataclasses, defaults and JSON schema are identical, so every
``configs/*.json`` loads unchanged in both packages.  Fields that only steer
the JAX package (``scan_layers``, ``use_pallas_cells``) are kept for schema
compatibility; the port's weight bridge reads ``scan_layers`` to know the
layout of a converted flax tree.  ``transnet.remat`` and ``jointnet.remat``
steer the port as they do the JAX package: the encoder's layers (or
Conformer blocks) and the unfused joint are recomputed in the backward
pass.

The original module's notes follow.

Replaces the reference's 3-layer config surface (JSON model/data config at
``config/config.json``, simple_parsing dataclasses at
``utils/lightningmodule_args.py:5-27`` / ``utils/inference_args.py:5-13``, and
the pytorch-lightning Trainer argparse merged at ``train.py:54``) with a single
JSON-loadable dataclass tree.  The JSON schema is a superset of the reference's
``config/config.json`` so reference configs load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class TransNetConfig:
    """Audio encoder ("transcription network").

    Mirrors reference ``config/config.json:3-11`` /
    ``networks/encoder.py:54-76``.
    """

    input_size: int = 80
    hidden_size: int = 1024
    output_size: int = 512
    num_layers: int = 8
    rnn_type: str = "gru"  # lstm | gru | rnn
    dropout: float = 0.2
    bidirectional: bool = True
    # encoder family: "rnn" (reference parity, networks/encoder.py:48-52)
    # or "conformer" (Gulati et al. 2020 — attention+conv blocks,
    # models/conformer.py). Conformer is full-context: bidirectional must
    # stay True so the streaming gates (which refuse bidirectional
    # encoders) apply; hidden_size becomes d_model, num_layers the block
    # count, time_reduction_stride the input frame-stacking subsampling
    # (always at the input — time_reduction_layer is ignored), and
    # rnn_type is ignored.
    arch: str = "rnn"
    # conformer-only knobs (ignored for arch="rnn")
    attention_heads: int = 8
    ff_multiplier: int = 4
    conv_kernel_size: int = 15
    # chunked-causal (STREAMING) conformer: 0 = full context (offline
    # only); C > 0 = each post-reduction frame attends to its own C-frame
    # chunk plus the previous attention_left_chunks chunks, and the conv
    # module turns causal — streamable with a per-block cache, exact vs
    # the offline masked forward (models/conformer.py). Requires
    # bidirectional=False (and full-context requires True) so the
    # existing streaming gates apply to the right variant.
    attention_chunk: int = 0
    attention_left_chunks: int = 4
    # conformer: compile ONE block body scanned over the L blocks instead
    # of inlining L copies (nn.scan over a stacked param layout under
    # 'blocks') — cuts first-compile time ~L-fold for deep stacks, same
    # math. Param layout differs from the per-block default; convert with
    # models.conformer.{stack,unstack}_conformer_block_params. Streaming
    # decode currently requires the per-block layout (scan_blocks=False);
    # train fast with the scan, convert once at export.
    scan_blocks: bool = False
    # with scan_blocks: scan over GROUPS of this many unrolled blocks
    # (length = num_layers / group). Measured at Conformer-L scale on
    # v5e: grouping does NOT recover the scan's backward-fusion loss
    # (G=1: 84.1 ms/step, G=2: 88.5, G=4: 98.2 — vs 57.0 fully
    # unrolled), so leave this at 1; the real trade is scan_blocks
    # itself (compile 15.7 s/bucket at MFU 0.31) vs unrolled (247 s at
    # MFU 0.46) — see BASELINE.md round-4 Conformer rows.
    scan_block_group: int = 1
    # rematerialize each RNN layer in the backward pass (HBM vs recompute)
    remat: bool = False
    # compile one uniform layer body (scan over layers 1..L-1) instead of L
    # separate scans — order-of-magnitude faster XLA compiles for deep stacks
    scan_layers: bool = True
    # persistent-VMEM Pallas recurrent kernel (ops/rnn_pallas.py):
    # "auto" (TPU + supported shapes), "off", or "interpret" (CPU debugging)
    use_pallas_cells: str = "auto"
    # Time reduction (frame stacking): after `time_reduction_layer` RNN
    # layers, stack every `time_reduction_stride` consecutive frames into one
    # (feature dim x stride), so the remaining layers, the joint lattice, and
    # the decoders run at 1/stride the frame rate.  The standard production
    # RNN-T throughput/memory lever the reference lacks (its encoder runs
    # every layer at the 10 ms frame rate, ``networks/encoder.py:67-75``).
    # stride=1 disables; layer=0 stacks the input features themselves;
    # layer=num_layers stacks right before the output projection.
    time_reduction_stride: int = 1
    time_reduction_layer: int = 1

    def __post_init__(self):
        if self.arch not in ("rnn", "conformer"):
            raise ValueError(f"unknown encoder arch {self.arch!r}; choose "
                             "'rnn' or 'conformer'")
        if self.arch == "conformer":
            if self.attention_chunk < 0 or self.attention_left_chunks < 0:
                raise ValueError("attention_chunk and attention_left_chunks "
                                 "must be >= 0")
            if self.attention_chunk == 0 and not self.bidirectional:
                raise ValueError(
                    "arch='conformer' with attention_chunk=0 requires "
                    "bidirectional=True: full-context attention is "
                    "non-streamable exactly like a bidirectional RNN and "
                    "must trip the same streaming gates")
            if self.attention_chunk > 0 and self.bidirectional:
                raise ValueError(
                    "the chunked-causal Conformer (attention_chunk > 0) is "
                    "a causal/streamable encoder: set bidirectional=False "
                    "so the streaming gates admit it")
            if self.hidden_size % self.attention_heads:
                raise ValueError(
                    f"hidden_size ({self.hidden_size}) must divide evenly "
                    f"into attention_heads ({self.attention_heads})")
        if self.time_reduction_stride < 1:
            raise ValueError(
                f"time_reduction_stride ({self.time_reduction_stride}) "
                "must be >= 1")
        if self.arch == "rnn" and self.time_reduction_stride > 1 and not (
                0 <= self.time_reduction_layer <= self.num_layers):
            raise ValueError(
                f"time_reduction_layer ({self.time_reduction_layer}) must "
                f"lie in [0, num_layers={self.num_layers}]")

    def output_lengths(self, lengths):
        """Encoder-output frame counts for input frame counts ``lengths``
        (array or int): ceil-divided by the time-reduction stride — a group
        with at least one valid frame is a valid output frame."""
        s = self.time_reduction_stride
        return lengths if s <= 1 else -(-lengths // s)

    def output_frames(self, t: int) -> int:
        """Static encoder-output sequence length for input length ``t``."""
        s = self.time_reduction_stride
        return t if s <= 1 else -(-t // s)


@dataclass(frozen=True)
class PredNetConfig:
    """Prediction network. Mirrors ``config/config.json:12-19`` /
    ``networks/decoder.py:57-80``.

    ``rnn_type``: "lstm" | "gru" | "rnn" (reference registry,
    ``networks/encoder.py:48-52``) or "stateless" — the stateless n-gram
    prediction network (Ghodsi et al. 2020, arXiv:2002.08898), where
    ``num_layers`` becomes the number of CONTEXT labels carried
    (num_layers=1 = bigram context, the paper's sweet spot); near-parity
    accuracy, and decode ticks lose the prednet scan entirely."""

    embedding_size: int = 72  # == vocab size
    hidden_size: int = 1024
    output_size: int = 512
    num_layers: int = 2
    rnn_type: str = "lstm"
    dropout: float = 0.2
    pad_token_id: int = 0
    # see TransNetConfig.use_pallas_cells
    use_pallas_cells: str = "auto"


@dataclass(frozen=True)
class JointNetConfig:
    """Joint network. Mirrors ``config/config.json:20-22`` /
    ``networks/transducer.py:27-39``."""

    num_classes: int = 72
    # "concat" (reference behavior, networks/transducer.py:64-67) or "add"
    # (per-side projections to hidden_size, activation after the sum).
    combine: str = "concat"
    hidden_size: int = 512  # only used by combine="add"
    # rematerialize the joint in the backward pass: the (B,T,U,De+Dd) GELU
    # activation otherwise dominates training HBM (SURVEY.md hard-part 3)
    remat: bool = True


@dataclass(frozen=True)
class ModelConfig:
    transnet: TransNetConfig = field(default_factory=TransNetConfig)
    prednet: PredNetConfig = field(default_factory=PredNetConfig)
    jointnet: JointNetConfig = field(default_factory=JointNetConfig)

    def __post_init__(self):
        # embedding_size is the VOCAB size (reference semantics: "number of
        # classification", networks/decoder.py:28,69) — the prednet embeds
        # the same label ids the joint classifies.  A table smaller than
        # num_classes makes in-vocab ids gather out of range, which XLA
        # fills with NaN (CPU) or clamps (TPU) instead of erroring: the
        # symptom is NaN losses with zero diagnostics.  Fail at config
        # construction instead.
        if self.prednet.embedding_size < self.jointnet.num_classes:
            raise ValueError(
                f"prednet.embedding_size ({self.prednet.embedding_size}) < "
                f"jointnet.num_classes ({self.jointnet.num_classes}): the "
                "embedding table must cover every label id the joint "
                "classifies (embedding_size is the vocab size, not the "
                "embedding dim — reference networks/decoder.py:28)")

    @staticmethod
    def from_dict(d: dict) -> "ModelConfig":
        return ModelConfig(
            transnet=TransNetConfig(**_filter_kwargs(TransNetConfig, d.get("transnet", {}))),
            prednet=PredNetConfig(**_filter_kwargs(PredNetConfig, d.get("prednet", {}))),
            jointnet=JointNetConfig(**_filter_kwargs(JointNetConfig, d.get("jointnet", {}))),
        )


@dataclass(frozen=True)
class AudioConfig:
    """Frontend config. Mirrors ``config/config.json:25-37`` and the
    log-mel pipeline at ``datamodule.py:48-90``."""

    window_stride_sec: float = 0.01
    window_size_sec: float = 0.025
    sample_rate: int = 16000
    window: str = "hann"  # reference loads "hamming" but never applies it;
    # torchaudio MelSpectrogram default (hann) is what actually ran
    # (datamodule.py:61-63). We make the window explicit and default to hann.
    normalize: bool = True
    spec_augment: bool = True
    n_mels: int = 80
    time_mask_para: int = 40
    freq_mask_para: int = 20
    time_mask_cnt: int = 1
    freq_mask_cnt: int = 1
    pad_token_id: int = 0

    @property
    def win_length(self) -> int:
        import math

        return int(math.ceil(self.sample_rate * self.window_size_sec))

    @property
    def n_fft(self) -> int:
        return self.win_length

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride_sec)


@dataclass(frozen=True)
class TextConfig:
    pad_token_id: int = 0
    bos_token_id: int = 2
    eos_token_id: int = 3


@dataclass(frozen=True)
class DataConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    text: TextConfig = field(default_factory=TextConfig)
    # Length bucketing: audio frame-count bucket boundaries; batches are padded
    # to the bucket upper edge so each bucket compiles exactly once.
    audio_buckets: tuple = (256, 512, 1024, 2048)
    label_buckets: tuple = (32, 64, 128, 256)

    @staticmethod
    def from_dict(d: dict) -> "DataConfig":
        kw: dict[str, Any] = {}
        if "audio" in d:
            kw["audio"] = AudioConfig(**_filter_kwargs(AudioConfig, d["audio"]))
        if "text" in d:
            kw["text"] = TextConfig(**_filter_kwargs(TextConfig, d["text"]))
        if "audio_buckets" in d:
            kw["audio_buckets"] = tuple(d["audio_buckets"])
        if "label_buckets" in d:
            kw["label_buckets"] = tuple(d["label_buckets"])
        return DataConfig(**kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training recipe. Mirrors reference ``model.py:110-126`` (AdamW +
    OneCycleLR per-step), ``scripts/run_train.sh:17-32`` (fp16, grad-accum 16),
    ``utils/lightningmodule_args.py:5-27``."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    warmup_ratio: float = 0.2  # OneCycle pct_start
    final_div_factor: float = 1e4
    div_factor: float = 25.0  # OneCycle initial_lr = max_lr / div_factor
    max_steps: int = 100_000
    accumulate_grad_batches: int = 1
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: int = 8
    precision: str = "bf16"  # "bf16" | "fp32"  (reference: fp16|fp32)
    seed: int = 42
    log_every_steps: int = 50
    val_every_steps: int = 1000
    checkpoint_dir: str = "checkpoints"
    save_top_k: int = 3  # top-k by val_cer (train.py:31-37)
    grad_clip_norm: Optional[float] = None
    # skip the optimizer update when the gradient is non-finite (inf/nan)
    # instead of poisoning the params — standard large-run hygiene for long
    # bf16 schedules; the step counter still advances and the event is
    # visible as metrics["nonfinite_grad"]. Off by default (reference
    # faithfulness: it has no such guard).
    skip_nonfinite_grads: bool = False
    # fused joint+loss: compute the joint lattice in T-chunks of this many
    # frames so the full (B,T,U,V) logits never materialize (0 = disabled).
    # Numerically identical to the unfused path; controls peak HBM.
    joint_chunk_frames: int = 256
    # param/grad histogram logging every N steps (0 = off) — the
    # wandb.watch(model, log="all") equivalent (reference train.py:27);
    # histograms are computed on device and cost one extra fwd+bwd per
    # watch step
    watch_every_steps: int = 0
    # tensor parallelism: shard the joint classifier's vocab dim over a
    # 'model' mesh axis of this many devices (Megatron column-parallel; the
    # factored RNN-T loss reduces over V with one psum — parallel/mesh.py).
    # 1 = pure data parallel. Device count must be divisible by it. The
    # memory/FLOP lever for large-vocab (BPE) joints.
    model_parallel: int = 1
    # Pipeline parallelism (pp): shard the encoder's layer stack over a
    # 'stage' mesh axis of this many devices and stream microbatches
    # through the stages GPipe-style (parallel/pipeline.py). 1 = off.
    # Composes with dp on a 2-D (data, stage) mesh — the Trainer builds it
    # and routes the REAL train_step's encoder through the schedule. Needs
    # num_layers % pipeline_stages == 0 and (for now) no time reduction.
    # The lever when one device's HBM cannot hold the whole layer stack.
    pipeline_stages: int = 1
    # GPipe microbatch count for the pipeline (bubble fraction
    # (D-1)/(M+D-1)); 0 = auto (= pipeline_stages). The per-device batch
    # must divide into it.
    pipeline_microbatches: int = 0
    # Sequence parallelism (sp): time-shard the encoder over a 'time' mesh
    # axis of this many devices with the wavefront (staircase) schedule
    # (parallel/wavefront.py). 1 = off. Unidirectional encoders only (a
    # bi layer's successor needs the full backward sweep). Composes with
    # dp on a 2-D (data, time) mesh. The lever for recordings whose
    # activations exceed one device's HBM.
    sequence_parallel: int = 1
    # ZeRO-1: shard the Adam moments (mu/nu, 2x params fp32) over the 'data'
    # mesh axis instead of replicating them. Params stay replicated; each
    # data shard updates its 1/N slice of the moments and GSPMD all-gathers
    # the param delta — same step math bit-for-bit, optimizer memory
    # divided by the data-parallel width (parallel/mesh.py). The reference
    # has no analogue (DDP replicates optimizer state, train.py:45).
    shard_optimizer_state: bool = False
    # raw-PCM batches: "float32" ships PCM as-is; "int16" ships peak-scaled
    # int16 + a per-utterance scale column, dequantized on device — half the
    # host->device transfer bytes at 16-bit precision (most corpora are
    # 16-bit PCM at the source anyway). Ignored for precomputed-feature
    # datasets.
    wav_transfer_dtype: str = "float32"
    # decode during validation
    greedy_max_symbols: int = 3  # reference max_iters=3 (model.py:76)
    # "greedy" (reference parity) or "beam" (batched device beam; measurably
    # lower CER — see BASELINE.md — at ~K x decode cost)
    val_decoder: str = "greedy"
    val_beam_width: int = 4
    # exponential moving average of the params (Polyak averaging), the
    # within-run complement of the offline top-k checkpoint averaging
    # (`inference.py --average_k`): 0 = off; typical 0.999-0.9999. Costs
    # one extra fp32 param copy in the TrainState; decode the averaged
    # weights with `--use_ema` / `Recognizer.from_checkpoint(use_ema=True)`.
    ema_decay: float = 0.0
    # optimizer family: "adamw" (reference parity, model.py:110-126),
    # "adafactor" (factored second moment — optimizer memory drops from 2x
    # params fp32 to ~row+col sums; the standard choice when Adam moments
    # dominate HBM), "lion" (sign-momentum, 1x params state), or "sgd"
    # (momentum 0.9). All share the lr schedule below.
    optimizer: str = "adamw"
    # lr schedule: "onecycle" (reference parity — cosine OneCycleLR),
    # "cosine" (linear warmup -> cosine decay to 0), "linear" (warmup ->
    # linear decay), "constant" (warmup -> flat)
    lr_schedule: str = "onecycle"
    # FastEmit low-latency regularization (arXiv:2010.11148): the RNN-T
    # loss backward scales the label-arc occupancy gradient by
    # (1 + lambda), training the model to emit labels earlier — the
    # standard streaming-ASR latency lever (typical 1e-3..1e-2; trades a
    # little CER for a large first-token-latency cut). 0 = off
    # (gradient-exact plain loss). Applies to every loss path
    # (factored / fused / unfused).
    fastemit_lambda: float = 0.0
    # variational weight noise (Graves 2012 §sec. "regularization",
    # arXiv:1211.3711 — the regularizer the original RNN-T paper trained
    # with, which the reference never implemented): fresh N(0, std^2)
    # noise added to every float param for each microbatch's forward;
    # grads are taken at the noisy point (straight-through). 0 = off.
    weight_noise_std: float = 0.0
    # shard-parallel feed (round 5): Arrow row fetches for upcoming batches
    # run on this many reader threads ahead of collate, overlapping cold
    # mmap page-fault IO waits that otherwise serialize the prefetch thread
    # at 100k-utterance scale (BASELINE.md soak; data/prefetch.py
    # ordered_readahead). <=1 = the serial pre-round-5 feed.
    feed_reader_threads: int = 2
    # max batches fetched ahead of the collate stage (bounds host RAM)
    feed_read_ahead: int = 4


@dataclass(frozen=True)
class InferenceConfig:
    """Mirrors ``utils/inference_args.py:5-13`` + recognize_beams defaults
    (networks/transducer.py:216-228)."""

    beam_width: int = 5
    improved: bool = True
    state_beam: float = 4.6
    expand_beam: float = 2.3
    lm_path: Optional[str] = None
    lm_weight: float = 1.0
    hotwords: tuple = ()
    hotword_weight: float = 10.0
    streaming_chunk_frames: int = 64


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    vocab_path: Optional[str] = None

    @staticmethod
    def from_dict(d: dict) -> "Config":
        ikw = _filter_kwargs(InferenceConfig, d.get("inference", {}))
        if "hotwords" in ikw:
            # JSON round-trips tuples as lists; the Config is a jit static
            # argument, so every field must stay hashable
            ikw["hotwords"] = tuple(ikw["hotwords"])
        return Config(
            model=ModelConfig.from_dict(d.get("model", {})),
            data=DataConfig.from_dict(d.get("data", {})),
            train=TrainConfig(**_filter_kwargs(TrainConfig, d.get("train", {}))),
            inference=InferenceConfig(**ikw),
            vocab_path=d.get("vocab_path"),
        )

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def tiny_config() -> Config:
    """North-star config 1: tiny RNN-T (2x320 LSTM encoder, 1-layer prednet,
    72-grapheme vocab)."""
    return Config(
        model=ModelConfig(
            transnet=TransNetConfig(
                input_size=80, hidden_size=320, output_size=320, num_layers=2,
                rnn_type="lstm", dropout=0.0, bidirectional=True,
            ),
            prednet=PredNetConfig(
                embedding_size=72, hidden_size=320, output_size=320,
                num_layers=1, rnn_type="lstm", dropout=0.0,
            ),
            jointnet=JointNetConfig(num_classes=72),
        )
    )


def base_config() -> Config:
    """The reference's trained model config (config/config.json)."""
    return Config()
