"""Weight bridge from the JAX package's flax params tree to the port.

Input: the flax params of ``rnntransducer_tpu``'s ``RNNTransducer`` as nested
dicts of numpy arrays (optionally wrapped in ``{"params": ...}``).  Output:
the port's ``state_dict``.  Layouts:

* RNN cells keep ``w_ih`` (in, G*H), ``w_hh`` (H, G*H), ``b_ih``, ``b_hh``
  in both packages; flax ``fwd_l`` / ``bwd_l`` map to ``fwd.l`` / ``bwd.l``.
* With ``scan_layers=True`` (and more than one layer in the stack) flax keeps
  layers 1..L-1 under ``stack/{fwd,bwd}`` with a leading (L-1) axis; the
  bridge unstacks them.
* flax ``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is (out, in).
* The embedding table is (V, H) in both.
* The Conformer (``arch="conformer"``): flax ``block_{i}/...`` maps to
  ``blocks.{i}...``; ``LayerNorm`` ``scale`` to ``weight``; the compact
  ``FeedForward``'s ``LayerNorm_0`` / ``Dense_0`` / ``Dense_1`` to ``norm``
  / ``dense0`` / ``dense1``; the depthwise conv kernel keeps its (K, 1, D).
  With ``scan_blocks=True`` flax keeps the blocks under ``blocks`` with a
  leading L axis, or with ``scan_block_group=G`` under ``blocks/g{j}``
  with a leading L/G axis (global block s*G + j); the bridge unstacks them.

Every shape is checked against the port's model for ``model_cfg`` and every
flax leaf must be used: a mismatch raises.  :func:`flax_from_state_dict`
maps the other way, for the params bundles both packages read
(``serve.export_params``).  ``save``/``load`` keep a converted bundle
(``config.json`` + ``params.pt``) for machines without flax.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from rnntransducer_tpu_torch.config import Config, ModelConfig

# (flax path, port key, index into a stacked leaf or None, transpose?)
Entry = Tuple[Tuple[str, ...], str, Optional[int], bool]

_CELL = ("w_ih", "w_hh", "b_ih", "b_hh")


def _stack_entries(flax: Tuple[str, ...], port: str, num_layers: int,
                   bidirectional: bool, scan: bool) -> Iterator[Entry]:
    for d in (("fwd", "bwd") if bidirectional else ("fwd",)):
        for layer in range(num_layers):
            for name in _CELL:
                key = f"{port}.{d}.{layer}.{name}"
                if scan and num_layers > 1 and layer > 0:
                    yield flax + ("stack", d, name), key, layer - 1, False
                else:
                    yield flax + (f"{d}_{layer}", name), key, None, False


def _dense_entries(flax: Tuple[str, ...], port: str) -> Iterator[Entry]:
    yield flax + ("kernel",), f"{port}.weight", None, True
    yield flax + ("bias",), f"{port}.bias", None, False


def _encoder_stacks(model_cfg: ModelConfig) -> Dict[str, int]:
    """Layers per encoder stack: "rnn" before the time-reduction point and
    "rnn_post" after it (as ``AudioEncoder`` splits them)."""
    t = model_cfg.transnet
    stride = t.time_reduction_stride
    k = t.time_reduction_layer if stride > 1 else 0
    if stride > 1 and 0 < k < t.num_layers:
        return {"rnn": k, "rnn_post": t.num_layers - k}
    return {"rnn": t.num_layers}


def _norm_entries(flax: Tuple[str, ...], port: str) -> Iterator[Entry]:
    yield flax + ("scale",), f"{port}.weight", None, False
    yield flax + ("bias",), f"{port}.bias", None, False


def _conformer_block_entries(i: int) -> Iterator[Tuple[Tuple[str, ...], str, bool]]:
    """(path inside the block, port key, transpose?) of block ``i``."""
    port = f"encoder.blocks.{i}"
    for ff in ("ff1", "ff2"):
        yield (ff, "LayerNorm_0", "scale"), f"{port}.{ff}.norm.weight", False
        yield (ff, "LayerNorm_0", "bias"), f"{port}.{ff}.norm.bias", False
        for n in ("0", "1"):
            yield (ff, f"Dense_{n}", "kernel"), f"{port}.{ff}.dense{n}.weight", True
            yield (ff, f"Dense_{n}", "bias"), f"{port}.{ff}.dense{n}.bias", False
    groups = (("attn", ("norm",), ("q_proj", "k_proj", "v_proj", "out")),
              ("conv", ("norm", "post_norm"), ("pre", "post")))
    for mod, norms, denses in groups:
        for n in norms:
            for path, key, _, tr in _norm_entries((mod, n), f"{port}.{mod}.{n}"):
                yield path, key, tr
        for n in denses:
            for path, key, _, tr in _dense_entries((mod, n), f"{port}.{mod}.{n}"):
                yield path, key, tr
    yield ("conv", "conv", "kernel"), f"{port}.conv.conv.weight", False
    yield ("conv", "conv", "bias"), f"{port}.conv.conv.bias", False
    for path, key, _, tr in _norm_entries(("final_norm",), f"{port}.final_norm"):
        yield path, key, tr


def _conformer_entries(t) -> Iterator[Entry]:
    """The Conformer encoder's parameters in the layout ``t.scan_blocks`` /
    ``t.scan_block_group`` give the flax tree."""
    yield from _dense_entries(("encoder", "in_proj"), "encoder.in_proj")
    G = max(1, t.scan_block_group)
    if t.scan_blocks and t.num_layers % G:
        raise ValueError(f"num_layers={t.num_layers} not divisible by "
                         f"scan_block_group={G}")
    for i in range(t.num_layers):
        if not t.scan_blocks:
            prefix, index = ("encoder", f"block_{i}"), None
        elif G == 1:
            prefix, index = ("encoder", "blocks"), i
        else:
            prefix, index = ("encoder", "blocks", f"g{i % G}"), i // G
        for path, key, tr in _conformer_block_entries(i):
            yield prefix + path, key, index, tr


def flax_layout(model_cfg: ModelConfig) -> Iterator[Entry]:
    """Every parameter of the model as (flax path, port key, index, transpose)."""
    t, p, j = model_cfg.transnet, model_cfg.prednet, model_cfg.jointnet
    if t.arch == "conformer":
        yield from _conformer_entries(t)
    else:
        for name, layers in _encoder_stacks(model_cfg).items():
            yield from _stack_entries(("encoder", name), f"encoder.{name}", layers,
                                      t.bidirectional, t.scan_layers)
    yield from _dense_entries(("encoder", "out_proj"), "encoder.out_proj")
    yield ("prednet", "embedding", "embedding"), "prednet.embedding.weight", None, False
    if p.rnn_type.lower() != "stateless":
        yield from _stack_entries(("prednet", "rnn"), "prednet.rnn", p.num_layers,
                                  False, False)
    yield from _dense_entries(("prednet", "out_proj"), "prednet.out_proj")
    for name in (("enc_proj", "dec_proj", "fc") if j.combine == "add" else ("fc",)):
        yield from _dense_entries(("joint", name), f"joint.{name}")


def _expected_shapes(model_cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    from rnntransducer_tpu_torch.models.transducer import RNNTransducer
    with torch.device("meta"):
        model = RNNTransducer(model_cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _get(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for part in path:
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(f"flax params lack {'/'.join(path)}")
        node = node[part]
    return node


def state_dict_from_flax(params: Mapping, model_cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """flax params tree (nested dicts of arrays) -> the port's state_dict of
    CPU tensors in the arrays' own dtype (float32 for a float32 tree)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    expected = _expected_shapes(model_cfg)
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for path, key, index, transpose in flax_layout(model_cfg):
        arr = np.asarray(_get(params, path))
        if arr.dtype not in (np.float16, np.float32, np.float64):
            arr = arr.astype(np.float32)  # e.g. bfloat16 leaves (ml_dtypes)
        used.add(path)
        if index is not None:
            arr = arr[index]
        if transpose:
            arr = arr.T
        if key not in expected:
            raise ValueError(f"port model has no parameter {key}")
        if tuple(arr.shape) != expected[key]:
            raise ValueError(
                f"{'/'.join(path)}: flax shape {tuple(arr.shape)} does not "
                f"give {key} {expected[key]} — the ModelConfig does not match "
                "these params")
        out[key] = torch.tensor(arr)
    extra = sorted("/".join(p) for p in set(_leaves(params)) - used)
    if extra:
        raise ValueError(f"flax params hold leaves the config does not use: {extra}")
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"no flax leaves for port parameters: {missing}")
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                         model_cfg: ModelConfig) -> Dict:
    """The inverse of :func:`state_dict_from_flax`: the port's state_dict ->
    the JAX package's flax params tree (nested dicts of numpy arrays), in
    the layout ``model_cfg`` gives it (:func:`flax_layout`: the RNN stacks,
    ``scan_layers``, the Conformer's ``scan_blocks`` / ``scan_block_group``).
    Float tensors keep their dtype, but bfloat16 (numpy has none), which
    becomes float32.  Every shape is checked against the port's model for
    ``model_cfg`` and every tensor must be used: a mismatch raises."""
    expected = _expected_shapes(model_cfg)
    layout = list(flax_layout(model_cfg))
    stacked: Dict[Tuple[str, ...], int] = {}
    for path, _, index, _ in layout:
        if index is not None:
            stacked[path] = max(stacked.get(path, 0), index + 1)
    missing = sorted({key for _, key, _, _ in layout} - set(state_dict))
    if missing:
        raise ValueError(f"state_dict lacks {missing}")
    extra = sorted(set(state_dict) - {key for _, key, _, _ in layout})
    if extra:
        raise ValueError(f"state_dict holds tensors the config does not use: {extra}")
    tree: Dict = {}
    for path, key, index, transpose in layout:
        value = state_dict[key].detach().cpu()
        if tuple(value.shape) != expected[key]:
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the config's "
                             f"model has {expected[key]}")
        if value.dtype == torch.bfloat16:
            value = value.float()
        arr = value.numpy()
        if transpose:
            arr = np.ascontiguousarray(arr.T)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if index is None:
            node[path[-1]] = arr
        else:
            node.setdefault(path[-1], np.zeros((stacked[path],) + arr.shape,
                                               arr.dtype))[index] = arr
    return tree


def random_flax_params(model_cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random weights in the JAX package's flax layout (nested dicts of
    float32 numpy arrays), drawn from ``generator``: RNN tensors uniform in
    +-1/sqrt(H), dense and depthwise conv kernels and biases uniform in
    +-1/sqrt(fan_in), the embedding standard normal, LayerNorm scales 1 and
    offsets 0."""
    expected = _expected_shapes(model_cfg)
    state_dict: Dict[str, torch.Tensor] = {}
    for path, key, _, _ in flax_layout(model_cfg):
        shape = expected[key]
        if key.endswith("embedding.weight"):
            value = torch.randn(shape, generator=generator)
        elif "norm" in path[-2].lower():  # LayerNorm: flax's init
            value = (torch.ones if path[-1] == "scale" else torch.zeros)(shape)
        elif key.endswith("conv.conv.weight") or key.endswith("conv.conv.bias"):
            # depthwise kernel (K, 1, D): fan-in K
            scale = 1.0 / float(expected[key.rsplit(".", 1)[0] + ".weight"][0]) ** 0.5
            value = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale
        else:
            if ".w_" in key or ".b_" in key:
                fan = expected[key.rsplit(".", 1)[0] + ".w_hh"][0]
            else:
                fan = expected[key.rsplit(".", 1)[0] + ".weight"][1]
            scale = 1.0 / float(fan) ** 0.5
            value = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale
        state_dict[key] = value
    return flax_from_state_dict(state_dict, model_cfg)


def save(directory: str, cfg: Config, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write ``config.json`` + ``params.pt`` (a plain tensor dict)."""
    os.makedirs(directory, exist_ok=True)
    cfg.to_json(os.path.join(directory, "config.json"))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(directory, "params.pt"))
    return directory


def load(directory: str) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """Read a bundle written by :func:`save` -> (Config, state_dict)."""
    cfg = Config.from_json(os.path.join(directory, "config.json"))
    sd = torch.load(os.path.join(directory, "params.pt"), map_location="cpu",
                    weights_only=True)
    return cfg, sd
