"""Parity of the port's training step with the JAX package.

``loss_fn`` (loss and every param grad) and ``train_step`` (metrics each
step, params after 3 AdamW steps) against the JAX ones on every joint+loss
branch (factored, fused, unfused), in fp32 with dropout 0 and SpecAugment
off; the JAX grads and params come through the port's weight bridge.
Tolerance 1e-5 (the JAX package's own for loss and gradients).  Then the
port alone: grad accumulation, the non-finite skip, dropout and SpecAugment
statistics with fixed generators, and the CUDA default of its entry points.
"""

import math

import numpy as np
import jax
import pytest
import torch

import rnntransducer_tpu.config as jcfg
from rnntransducer_tpu.train.optim import make_optimizer as jax_make_optimizer
from rnntransducer_tpu.train.state import TrainState as JaxTrainState
from rnntransducer_tpu.train.state import loss_fn as jax_loss_fn
from rnntransducer_tpu.train.state import train_step as jax_train_step

import rnntransducer_tpu_torch.config as pcfg
from rnntransducer_tpu_torch.frontend.specaugment import spec_augment
from rnntransducer_tpu_torch.models.cells import StackedRNN, drop_thresh, fast_dropout
from rnntransducer_tpu_torch.models.transducer import RNNTransducer, build_model
from rnntransducer_tpu_torch.train import TrainState, eval_step, loss_fn, train_step
from rnntransducer_tpu_torch.utils.weights import state_dict_from_flax

from _torch_parity import close, model_dict

TOL = 1e-5
B, T, U, M, V = 4, 12, 4, 8, 11

BRANCHES = {
    "factored": dict(combine="concat", chunk=256),
    "fused": dict(combine="add", chunk=5),
    "unfused": dict(combine="concat", chunk=0),
}


def _config_dict(branch, **train):
    b = BRANCHES[branch]
    return {"model": model_dict(combine=b["combine"], n_mels=M, vocab=V),
            "data": {"audio": {"spec_augment": False}},
            "train": {"precision": "fp32", "joint_chunk_frames": b["chunk"],
                      "learning_rate": 1e-3, "max_steps": 10, **train}}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    targets = rng.randint(1, V, size=(B, U)).astype(np.int32)
    return {"feats": rng.randn(B, T, M).astype(np.float32),
            "feat_lengths": np.array([12, 9, 5, 2], np.int32),
            "text_in": np.concatenate([np.zeros((B, 1), np.int32), targets], 1),
            "text_lengths": np.array([5, 4, 2, 1], np.int32),
            "targets": targets,
            "target_lengths": np.array([4, 3, 1, 0], np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _bridge(tree, cfg):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), cfg.model)


def _both(branch, **train):
    d = _config_dict(branch, **train)
    jc, pc = jcfg.Config.from_dict(d), pcfg.Config.from_dict(d)
    jstate = JaxTrainState.create(jc)
    state = TrainState.create(pc, "cpu", state_dict=_bridge(jstate.params, pc))
    return jc, pc, jstate, state


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_loss_fn_and_grads_match_jax(branch):
    jc, pc, jstate, state = _both(branch)
    batch = _batch()
    model = RNNTransducer(jc.model)
    jb = jax.tree_util.tree_map(jax.numpy.asarray, batch)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, jc, p, jb, jax.random.PRNGKey(0),
                              deterministic=True)))(jstate.params)
    params = state.params
    got = loss_fn(state.model, pc, params, _torch_batch(batch), None,
                  deterministic=True)
    grads = torch.autograd.grad(got, list(params.values()))
    close(got, want, atol=TOL, rtol=TOL)
    close(eval_step(pc, state.model, _torch_batch(batch)), want, atol=TOL, rtol=TOL)
    want_g = _bridge(want_g, pc)
    assert set(want_g) == set(params)
    for (name, _), g in zip(params.items(), grads):
        close(g, want_g[name], atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_three_adamw_steps_match_jax(branch):
    jc, pc, jstate, state = _both(branch)
    batch = _batch(1)
    tx = jax_make_optimizer(jc.train)
    jb = jax.tree_util.tree_map(jax.numpy.asarray, batch)
    tb = _torch_batch(batch)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    for step in range(3):
        jstate, jm = jax_train_step(jc, tx, jstate, jb)
        m = train_step(state, tb)
        close(m["loss"], jm["loss"], atol=TOL, rtol=TOL, err_msg=f"loss {step}")
        close(m["grad_norm"], jm["grad_norm"], atol=TOL, rtol=TOL,
              err_msg=f"grad_norm {step}")
        assert int(m["nonfinite_grad"]) == int(jm["nonfinite_grad"]) == 0
    assert state.step == state.updates == 3
    want = _bridge(jstate.params, pc)
    moved = 0.0
    for name, p in state.params.items():
        close(p, want[name], atol=TOL, err_msg=name)
        moved = max(moved, (p - start[name]).abs().max().item())
    assert moved > 100 * TOL  # the comparison is not of untouched params


def test_grad_accumulation_of_two_equals_the_whole_batch():
    """SGD's first update is -lr * grad, so equal params after one step
    means equal grads: two contiguous microbatches of 2 vs one of 4."""
    batch = _torch_batch(_batch(2))
    out = []
    for accum in (1, 2):
        d = _config_dict("factored", optimizer="sgd", learning_rate=0.5,
                         accumulate_grad_batches=accum)
        state = TrainState.create(pcfg.Config.from_dict(d), "cpu")
        start = {k: v.detach().clone() for k, v in state.params.items()}
        m = train_step(state, batch)
        out.append((m, {k: v.detach() - start[k] for k, v in state.params.items()}))
    (m1, d1), (m2, d2) = out
    close(m2["loss"], m1["loss"].numpy(), atol=TOL, rtol=TOL)
    close(m2["grad_norm"], m1["grad_norm"].numpy(), atol=TOL, rtol=TOL)
    for k in d1:
        close(d2[k], d1[k].numpy(), atol=1e-6, err_msg=k)


def test_skip_nonfinite_grads_leaves_params_and_moments_untouched():
    d = _config_dict("factored", skip_nonfinite_grads=True)
    state = TrainState.create(pcfg.Config.from_dict(d), "cpu")
    good = _torch_batch(_batch(3))
    train_step(state, good)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    moments = {k: {n: s.clone() for n, s in st.items()}
               for k, st in state.optimizer.state.items()}
    bad = dict(good, feats=good["feats"].clone())
    bad["feats"][0, 0, 0] = float("nan")
    m = train_step(state, bad)
    assert int(m["nonfinite_grad"]) == 1 and not math.isfinite(float(m["grad_norm"]))
    assert state.step == 2 and state.updates == 1
    for k, v in state.params.items():
        assert torch.equal(v, params[k]), k
    for p, st in state.optimizer.state.items():
        for n, s in st.items():
            assert torch.equal(s, moments[p][n]), n
    m = train_step(state, good)  # and training goes on from there
    assert int(m["nonfinite_grad"]) == 0 and state.updates == 2


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_fast_dropout_keep_rate_and_mean(rate):
    n = 200_000
    x = torch.ones(n)
    out = fast_dropout(x, rate, torch.Generator().manual_seed(int(rate * 100)))
    keep_p = 1.0 - drop_thresh(rate) / 256.0
    kept = int((out != 0).sum())
    bound = 5 * math.sqrt(n * keep_p * (1 - keep_p))  # 5 binomial sigmas
    assert abs(kept - n * keep_p) < bound
    assert torch.all((out == 0) | (out == torch.tensor(1.0 / keep_p)))
    assert abs(out.mean().item() - 1.0) < bound / (n * keep_p)
    gen = torch.Generator().manual_seed(0)
    assert fast_dropout(x, rate, None) is x               # no generator: eval
    assert fast_dropout(x, 1.0 / 600, gen) is x           # quantizes to 0/256
    assert not fast_dropout(x, 1.0, gen).any()


def test_dropout_sits_between_layers_only():
    """Inter-layer dropout: a one-layer stack is untouched (never on the last
    layer's output); a two-layer stack differs from its dropout-free run."""
    torch.manual_seed(0)
    x = torch.randn(3, 6, 5)
    for layers, changes in ((1, False), (2, True)):
        rnn = StackedRNN(5, 7, layers, "gru", bidirectional=True, dropout=0.5)
        with torch.no_grad():
            for p in rnn.parameters():
                p.uniform_(-0.3, 0.3)
            plain, _ = rnn(x)
            dropped, _ = rnn(x, generator=torch.Generator().manual_seed(1))
        assert (not torch.equal(plain, dropped)) == changes


@pytest.mark.parametrize("site", ["encoder_boundary", "stateless_prednet"])
def test_dropout_sites_outside_the_stacks(site):
    """The encoder's boundary dropout between its two stacks (one layer
    each, so no stack has an inner site) and the stateless prediction
    network's context dropout act only with a generator."""
    if site == "encoder_boundary":
        d = model_dict(layers=2, stride=2, reduce_at=1, n_mels=M, vocab=V)
        d["transnet"]["dropout"] = 0.5
        args = (torch.randn(2, 8, M),)
        fn = lambda m, g: m.encode(*args, generator=g)[0]
    else:
        d = model_dict(pred_type="stateless", pred_layers=1, n_mels=M, vocab=V)
        d["prednet"]["dropout"] = 0.5
        args = (torch.tensor([[0, 3, 5, 2], [0, 1, 1, 0]]),)
        fn = lambda m, g: m.predict(*args, generator=g)[0]
    model = build_model(pcfg.ModelConfig.from_dict(d), "cpu")
    with torch.no_grad():
        plain = fn(model, None)
        assert torch.equal(plain, fn(model, None))
        assert not torch.equal(plain, fn(model, torch.Generator().manual_seed(0)))


def test_spec_augment_spans_within_their_paras():
    Bs, Ts, Ms = 64, 100, 40
    lengths = torch.tensor([100, 80, 30, 5] * 16)
    out = spec_augment(torch.ones(Bs, Ts, Ms), torch.Generator().manual_seed(0),
                       lengths, freq_para=10, time_para=20)
    freq_masked = (out == 0).all(dim=1)           # (B, M): whole columns
    time_masked = (out == 0).all(dim=2)           # (B, T): whole rows
    for b in range(Bs):
        f = freq_masked[b].nonzero().flatten()
        tm = time_masked[b].nonzero().flatten()
        assert len(f) <= 10 and len(tm) <= 20
        for span in (f, tm):                      # one contiguous span each
            if len(span):
                assert span[-1] - span[0] + 1 == len(span)
        if len(tm):
            assert tm[-1] < lengths[b]            # inside the valid frames
        assert (out[b] != 0).any()
    assert freq_masked.any(1).float().mean() > 0.5  # masks are not all empty
    assert len({tuple(r.nonzero().flatten().tolist()) for r in freq_masked}) > 10


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pcfg.Config.from_dict(_config_dict("factored"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, trainable=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainState.create(cfg)
    model = build_model(cfg, "cpu", trainable=True)
    assert model.training
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
