"""The port's debugging tools (``rnntransducer_tpu_torch/utils/debugging.py``)
on the CPU: ``checked_rnnt_loss`` against the JAX package's checkify
version (the same checks fire on the same inputs with the same messages;
the loss to 1e-5 relative, tests/test_rnnt_loss.py's tolerance),
``debug_nans`` naming the module that made a NaN, and the kernel wrappers
routing by their tensors' device alone (the JAX ``force_interpret`` has no
counterpart)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnntransducer_tpu.utils import debugging as jdebug

from rnntransducer_tpu_torch import config as pcfg
from rnntransducer_tpu_torch.frontend import fused_frontend
from rnntransducer_tpu_torch.ops import rnn_kernels, rnnt_kernels
from rnntransducer_tpu_torch.utils import debugging

B, T, U, V = 3, 6, 4, 9
CHECK_SUFFIX = " (`check` failed)"   # checkify's addition to a check's message


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return dict(logits=rng.randn(B, T, U + 1, V).astype(np.float32),
                labels=rng.randint(1, V, (B, U)).astype(np.int32),
                logit_lengths=np.array([T, 4, 1], np.int32),
                label_lengths=np.array([U, 2, 0], np.int32))


def _broken(case):
    x = _loss_inputs()
    if case == "logit_lengths_zero":
        x["logit_lengths"][1] = 0
    elif case == "logit_lengths_over_T":
        x["logit_lengths"][0] = T + 1
    elif case == "label_lengths_over_U":
        x["label_lengths"][2] = U + 1
    elif case == "negative_label_lengths":
        x["label_lengths"][1] = -1
    elif case == "label_id_V":
        x["labels"][0, 1] = V
    elif case == "negative_label_id":
        x["labels"][2, 0] = -1
    elif case == "non_finite_logits":
        x["logits"][0, 0, 0, 0] = np.nan
    return x


@pytest.mark.parametrize("case", [
    "logit_lengths_zero", "logit_lengths_over_T", "label_lengths_over_U",
    "negative_label_lengths", "label_id_V", "negative_label_id", "non_finite_logits"])
def test_each_check_fires_as_the_jax_one(case):
    x = _broken(case)
    jerr, _ = jdebug.checked_rnnt_loss(*(jnp.asarray(v) for v in x.values()))
    want = jerr.get()
    assert want is not None and want.endswith(CHECK_SUFFIX)
    err, loss = debugging.checked_rnnt_loss(*(torch.from_numpy(v) for v in x.values()))
    assert err is not None and err.get() == want[:-len(CHECK_SUFFIX)]
    with pytest.raises(ValueError) as raised:
        err.throw()
    assert str(raised.value) == err.get()
    if case == "non_finite_logits":
        assert not torch.isfinite(loss)
    else:
        assert loss is None        # an input check failed: no loss computed
    if case == "label_id_V":
        assert "vocab/tokenizer mismatch?" in err.get()


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_loss_equals_the_jax_one(reduction):
    x = _loss_inputs(1)
    jerr, jloss = jdebug.checked_rnnt_loss(*(jnp.asarray(v) for v in x.values()),
                                           blank=0, reduction=reduction)
    assert jerr.get() is None
    err, loss = debugging.checked_rnnt_loss(*(torch.from_numpy(v) for v in x.values()),
                                            blank=0, reduction=reduction)
    assert err is None
    want = float(jloss)
    assert abs(loss.item() - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------


class _LogOf(torch.nn.Module):
    """log(x): NaN for a negative input."""

    def forward(self, x):
        return torch.log(x)


class _NaNGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_debug_nans_names_the_module_and_turns_off():
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), _LogOf(), torch.nn.Linear(4, 2))
    with torch.no_grad():
        model[0].weight.copy_(-torch.eye(4))
        model[0].bias.zero_()
    x = torch.ones(2, 4)
    try:
        debugging.debug_nans(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(FloatingPointError, match="non-finite output of module _LogOf"):
            model(x)
        assert torch.isfinite(model[0](x)).all()     # finite outputs pass
        y = _NaNGrad.apply(torch.ones(3, requires_grad=True))
        with pytest.raises(RuntimeError, match="returned nan values"):
            y.sum().backward()
        debugging.debug_nans(True)                   # a second call adds no hook
    finally:
        debugging.debug_nans(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(model(x)).all()               # off again: no raise


# ---------------------------------------------------------------------------
# the kernel wrappers' routes (no force_interpret counterpart)
# ---------------------------------------------------------------------------


def _wrapper_call(name, device="cpu"):
    """(wrapper, its plain version, arguments on ``device``) at a small
    shape."""
    rng = np.random.RandomState(2)
    Tn, Bn, H = 3, 2, 8

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3).to(device)

    lengths = torch.tensor([3, 1], device=device)
    if name == "gru_scan":
        return (rnn_kernels.gru_scan, rnn_kernels.gru_scan_reference,
                (r(Tn, Bn, 3 * H), r(H, 3 * H), r(3 * H), r(Bn, H), lengths))
    if name == "gru_scan_backward":
        return (rnn_kernels.gru_scan_backward, rnn_kernels.gru_scan_backward_reference,
                (r(Tn, Bn, 3 * H), r(Tn, Bn, H), r(H, 3 * H), r(3 * H), lengths,
                 r(Tn, Bn, H), r(Bn, H)))
    if name == "lstm_scan":
        return (rnn_kernels.lstm_scan, rnn_kernels.lstm_scan_reference,
                (r(Tn, Bn, 4 * H), r(H, 4 * H), r(4 * H), r(Bn, H), r(Bn, H), lengths))
    if name == "lstm_scan_backward":
        return (rnn_kernels.lstm_scan_backward, rnn_kernels.lstm_scan_backward_reference,
                (r(Tn, Bn, 4 * H), r(Tn, Bn, H), r(Tn, Bn, H), r(H, 4 * H), r(4 * H),
                 lengths, r(Tn, Bn, H), r(Bn, H), r(Bn, H)))
    if name == "sweep":
        return (rnnt_kernels.sweep, rnnt_kernels.sweep_reference,
                (-r(2, 5, 4).abs(), -r(2, 5, 4).abs()))
    cfg = pcfg.AudioConfig()
    return (fused_frontend.logmel_fused, fused_frontend.logmel_fused_reference,
            (r(2, 1600), cfg))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["gru_scan", "gru_scan_backward", "lstm_scan",
                                  "lstm_scan_backward", "sweep", "logmel_fused"])
def test_wrapper_routes_by_device_only(name):
    """The JAX package's ``force_interpret`` has no counterpart: a wrapper's
    route is its tensor's device and nothing else.  A CPU tensor gets the
    plain version with no launch counted; a tensor on neither the CPU nor
    a CUDA card raises, before any plain version runs."""
    wrapper, plain, args = _wrapper_call(name)
    before = wrapper.launches
    assert _equal(wrapper(*args), plain(*args))
    assert wrapper.launches == before
    _, _, meta_args = _wrapper_call(name, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        wrapper(*meta_args)


def test_cli_debug_nans_is_on_for_the_run_only(tmp_path, monkeypatch):
    """``cli.train --debug_nans`` turns the checks on for its run (every
    module's forward is checked) and off when it returns."""
    from rnntransducer_tpu_torch.cli import train as cli

    cfg = pcfg.Config(
        data=pcfg.DataConfig(audio=pcfg.AudioConfig(spec_augment=False),
                             audio_buckets=(400, 801), label_buckets=(48,)),
        model=pcfg.ModelConfig(
            transnet=pcfg.TransNetConfig(input_size=80, hidden_size=8, output_size=8,
                                         num_layers=1, rnn_type="gru", dropout=0.0),
            prednet=pcfg.PredNetConfig(embedding_size=72, hidden_size=8, output_size=8,
                                       num_layers=1, rnn_type="lstm", dropout=0.0),
            jointnet=pcfg.JointNetConfig(num_classes=72)),
        train=pcfg.TrainConfig(max_steps=1, per_device_train_batch_size=2,
                               per_device_eval_batch_size=2, precision="fp32",
                               val_every_steps=100, checkpoint_dir=str(tmp_path / "c")))
    path = str(tmp_path / "config.json")
    cfg.to_json(path)
    checked = []
    real = debugging._check_output
    monkeypatch.setattr(debugging, "_check_output",
                        lambda m, i, o: checked.append(type(m).__name__) or real(m, i, o))
    state = cli.main(["--config", path, "--synthetic", "4", "--device", "cpu",
                      "--debug_nans"])
    assert state.step == 1
    assert {"AudioEncoder", "RNNLayer"} <= set(checked)
    assert not torch.is_anomaly_enabled() and debugging._nan_hook is None
