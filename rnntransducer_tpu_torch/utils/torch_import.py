"""Import of the original PyTorch(-Lightning) RNNTransducer checkpoints (port
of ``rnntransducer_tpu/utils/torch_import.py``).

A model trained with the reference repository (its module tree: an
``encoder`` with ``rnn`` + ``out_proj``, a ``decoder`` with ``embedding``,
``rnn`` + ``out_proj``, and the joint's ``fc``) loads straight into the
port's module names, so it can be served, evaluated or fine-tuned here.
The JAX package maps the same checkpoint onto its flax tree; both follow
one layout mapping:

* ``torch.nn.{LSTM,GRU,RNN}`` ``weight_ih_l{k}[_reverse]`` is (G*H, in);
  the port's ``w_ih`` is (in, G*H), as flax's: transpose.  ``weight_hh``
  likewise; the biases are kept.  The gate order is the same (i, f, g, o /
  r, z, n, with the GRU's ``b_hn`` inside ``r * (...)`` in both), and the
  ``_reverse`` suffix is the ``bwd`` direction.
* ``torch.nn.Linear.weight`` is (out, in) in both (flax's ``Dense.kernel``
  is its transpose).
* ``torch.nn.Embedding.weight`` is (V, H) in both.
* A Lightning checkpoint holds the model's ``state_dict`` under the key
  ``state_dict``, its names prefixed (``jointnet.``); the prefix is found
  from the encoder's first weight and dropped.

Every shape is checked against the port's model for the given
``ModelConfig``; a mismatch raises with the checkpoint's and the config's
shapes.  ``convert_to_checkpoint`` writes a step-0 checkpoint of the port
(``<dir>/0/state.pt`` + ``config.json``) that ``Recognizer.from_checkpoint``,
the CLIs, ``serve_socket`` and ``Trainer.fit(resume=True)`` restore.

    python -m rnntransducer_tpu_torch.utils.torch_import \\
        --torch_ckpt ref.ckpt --config config.json --out_dir ckpts
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import torch

from rnntransducer_tpu_torch.config import Config, ModelConfig
from rnntransducer_tpu_torch.utils.weights import _encoder_stacks, _expected_shapes

_ANCHOR = "encoder.rnn.weight_ih_l0"
# reference RNN tensor -> port cell tensor, transpose?
_CELL = (("weight_ih", "w_ih", True), ("weight_hh", "w_hh", True),
         ("bias_ih", "b_ih", False), ("bias_hh", "b_hh", False))


def strip_prefix(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict with the module prefix dropped (the Lightning module
    nests everything under ``jointnet.``; a bare JointNet state_dict has no
    prefix), as float32 CPU tensors."""
    prefix = next((k[:len(k) - len(_ANCHOR)] for k in state_dict
                   if k.endswith(_ANCHOR)), None)
    if prefix is None:
        raise KeyError(f"no '*{_ANCHOR}' key — not an RNNTransducer state_dict? "
                       f"got keys like {list(state_dict)[:5]}")
    return {k[len(prefix):]: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in state_dict.items() if k.startswith(prefix)}


def _rnn_entries(ref: str, port_stacks: Mapping[str, int],
                 bidirectional: bool) -> Iterator[Tuple[str, str, bool]]:
    """Reference layer k of ``ref`` (e.g. ``encoder.rnn.``) in order over the
    port's stacks (``{"encoder.rnn": k, "encoder.rnn_post": L - k}``)."""
    dirs = (("fwd", ""), ("bwd", "_reverse")) if bidirectional else (("fwd", ""),)
    k = 0
    for stack, layers in port_stacks.items():
        for layer in range(layers):
            for d, sfx in dirs:
                for src, dst, transpose in _CELL:
                    yield (f"{ref}{src}_l{k}{sfx}", f"{stack}.{d}.{layer}.{dst}",
                           transpose)
            k += 1


def reference_layout(model_cfg: ModelConfig) -> Iterator[Tuple[str, str, bool]]:
    """Every parameter as (reference key, port key, transpose?)."""
    t, p = model_cfg.transnet, model_cfg.prednet
    stacks = {f"encoder.{name}": n for name, n in _encoder_stacks(model_cfg).items()}
    yield from _rnn_entries("encoder.rnn.", stacks, t.bidirectional)
    yield "encoder.out_proj.weight", "encoder.out_proj.weight", False
    yield "encoder.out_proj.bias", "encoder.out_proj.bias", False
    yield "decoder.embedding.weight", "prednet.embedding.weight", False
    yield from _rnn_entries("decoder.rnn.", {"prednet.rnn": p.num_layers}, False)
    yield "decoder.out_proj.weight", "prednet.out_proj.weight", False
    yield "decoder.out_proj.bias", "prednet.out_proj.bias", False
    yield "fc.weight", "joint.fc.weight", False
    yield "fc.bias", "joint.fc.bias", False


def params_from_torch_state_dict(state_dict: Mapping, model_cfg: ModelConfig
                                 ) -> Dict[str, torch.Tensor]:
    """Reference JointNet / Lightning state_dict -> the port's state_dict
    (float32 CPU tensors).

    Raises ``ValueError`` when a shape the config implies differs from the
    checkpoint's (the wrong config for this checkpoint), ``KeyError`` when
    a tensor is missing."""
    if model_cfg.jointnet.combine != "concat":
        raise ValueError("reference checkpoints use the concat joint; got "
                         f"combine={model_cfg.jointnet.combine!r}")
    sd = strip_prefix(state_dict)
    expected = _expected_shapes(model_cfg)
    out: Dict[str, torch.Tensor] = {}
    for src, dst, transpose in reference_layout(model_cfg):
        if src not in sd:
            raise KeyError(f"the checkpoint has no '{src}' (the config expects "
                           f"{model_cfg.transnet.num_layers} encoder and "
                           f"{model_cfg.prednet.num_layers} prediction-network "
                           "layers)")
        value = sd[src].t() if transpose else sd[src]
        if tuple(value.shape) != expected[dst]:
            raise ValueError(
                f"{src}: checkpoint shape {tuple(value.shape)} != config shape "
                f"{expected[dst]} (port {dst}) — the ModelConfig does not "
                "match this checkpoint")
        out[dst] = value.contiguous()
    return out


def load_torch_checkpoint(path: str, model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Load a .ckpt / .pt file (a Lightning checkpoint with a ``state_dict``
    entry, or a bare state_dict) and return the port's state_dict.  A
    Lightning checkpoint pickles more than tensors, so the file is
    unpickled in full: load only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return params_from_torch_state_dict(sd, model_cfg)


def convert_to_checkpoint(torch_ckpt: str, cfg: Config, out_dir: str,
                          device=None) -> str:
    """Import a reference checkpoint and write a step-0 checkpoint of the
    port to ``out_dir`` through ``CheckpointManager`` (fresh optimizer
    state).  ``device``: where the train state is built, default cuda
    (raises without a card)."""
    from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
    from rnntransducer_tpu_torch.train.state import TrainState
    from rnntransducer_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # before the file is read
    state = TrainState.create(cfg, device,
                              state_dict=load_torch_checkpoint(torch_ckpt, cfg.model))
    mgr = CheckpointManager(out_dir, save_top_k=1)
    mgr.save(0, state, metrics={}, config=cfg)
    mgr.close()
    return out_dir


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference PyTorch RNNTransducer checkpoint into "
                    "a checkpoint directory of the port.")
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--config", required=True,
                    help="config.json (the JAX package's schema) of the checkpoint")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    convert_to_checkpoint(args.torch_ckpt, Config.from_json(args.config),
                          args.out_dir, device=args.device)
    print(f"wrote a port checkpoint (step 0) to {args.out_dir}")


if __name__ == "__main__":
    main()
