"""The plain reference against the port on the CPU at tiny sizes: the same
weights (the state dict the harness makes from a seed) through both."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness.common import deep_update, load_json, BENCH_DIR
from benchmark.reference.frontend import logmel
from benchmark.reference.loss import lattice_logprobs, rnnt_nll
from benchmark.reference.model import Reference, param_specs, seeded_params
from benchmark.reference.train import onecycle_lr, readings, reference_steps
from benchmark.reference.walk import walk

CONFIGS = ("gru_flagship", "conformer_l_stream")


def _tiny(name):
    c = load_json(BENCH_DIR / "configs" / f"{name}.json")
    c = deep_update(c, c["rehearsal"])
    return c["run"], c["weights"]


def _port(run, params):
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.models.transducer import build_model
    return build_model(Config.from_dict(run), "cpu", state_dict=params)


def _params(run, w, seed=3):
    return seeded_params(param_specs(run["model"]), torch.Generator().manual_seed(seed),
                         "cpu", blank_bias=w["blank_bias"], suppressed=w["suppressed"],
                         suppress_bias=w["suppress_bias"], encoder_gain=w["encoder_gain"])


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_are_the_port_state_dict(name):
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.models.transducer import RNNTransducer
    for run in (_tiny(name)[0], load_json(BENCH_DIR / "configs" / f"{name}.json")["run"]):
        with torch.device("meta"):
            port = RNNTransducer(Config.from_dict(run).model)
        want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        got = {n: tuple(s) for n, s, _, _ in param_specs(run["model"])}
        assert got == want


def _batch(run, B=3, seed=0):
    rng = np.random.RandomState(seed)
    frames = [120, 77, 41][:B]
    feats = torch.from_numpy(rng.randn(B, max(frames), 80).astype(np.float32))
    lens = torch.tensor(frames)
    U = [5, 3, 7][:B]
    labels = torch.zeros((B, max(U)), dtype=torch.int64)
    for i, u in enumerate(U):
        labels[i, :u] = torch.from_numpy(rng.randint(4, 40, u))
    return feats, lens, labels, torch.tensor(U)


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_prednet_joint_loss_match_the_port(name):
    from rnntransducer_tpu_torch.ops.rnnt_loss import rnnt_loss
    run, w = _tiny(name)
    P = _params(run, w)
    port = _port(run, P)
    ref = Reference(run["model"], P)
    feats, lens, labels, U = _batch(run)
    text_in = torch.cat([torch.zeros_like(labels[:, :1]), labels], 1)
    with torch.no_grad():
        e_ref, el = ref.encode(feats, lens)
        e_port, _ = port.encode(feats, lens)
        for i in range(len(lens)):
            n = int(el[i])
            torch.testing.assert_close(e_ref[i, :n], e_port[i, :n], rtol=1e-4, atol=1e-5)
        d_ref = ref.predict(text_in, U + 1)
        d_port, _ = port.predict(text_in, U + 1)
        for i in range(len(U)):
            torch.testing.assert_close(d_ref[i, :int(U[i]) + 1], d_port[i, :int(U[i]) + 1],
                                       rtol=1e-4, atol=1e-5)
        A, C = ref.factors(e_ref, d_ref)
        logits = port(feats, lens, text_in, U + 1)
        lat = A[:, :, None] + C[:, None]
        for i in range(len(U)):
            n, u = int(el[i]), int(U[i]) + 1
            torch.testing.assert_close(lat[i, :n, :u], logits[i, :n, :u], rtol=1e-4,
                                       atol=1e-4)
        lpb, lpe = lattice_logprobs(A, C, labels, 0)
        nll = rnnt_nll(lpb, lpe, el, U)
        want = rnnt_loss(logits, labels, el, U, blank=0, reduction="none")
        torch.testing.assert_close(nll.float(), want.float(), rtol=1e-4, atol=1e-4)


def test_streaming_conformer_steps_equal_the_masked_forward():
    """The chunk-by-chunk port (the runner's path) equals the reference's
    masked chunked-causal forward over the whole utterance."""
    from rnntransducer_tpu_torch.decode.streaming import _zero_encoder_state
    run, w = _tiny("conformer_l_stream")
    P = _params(run, w)
    port = _port(run, P)
    ref = Reference(run["model"], P)
    tn = run["model"]["transnet"]
    chunk = tn["attention_chunk"] * tn["time_reduction_stride"]
    feats = torch.randn(1, 5 * chunk - 9, 80, generator=torch.Generator().manual_seed(1))
    T = feats.shape[1]
    with torch.no_grad():
        want, wl = ref.encode(feats, torch.tensor([T]))
        state = _zero_encoder_state(port, 1)
        outs = []
        for s in range(0, T, chunk):
            piece = torch.zeros(1, chunk, 80)
            n = min(chunk, T - s)
            piece[0, :n] = feats[0, s:s + n]
            out, state = port.encode(piece, torch.tensor([n]), state)
            outs.append(out[0, :-(-n // tn["time_reduction_stride"])])
    torch.testing.assert_close(torch.cat(outs), want[0, :int(wl[0])], rtol=1e-4, atol=1e-5)


def test_logmel_matches_the_port_frontends():
    from rnntransducer_tpu_torch.config import AudioConfig
    from rnntransducer_tpu_torch.frontend.fused_frontend import logmel_fused_reference
    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    run, _ = _tiny("gru_flagship")
    audio = run["data"]["audio"]
    rng = np.random.RandomState(0)
    waves = [rng.randn(n).astype(np.float32) * 0.3 for n in (16000, 9001, 4321)]
    got, n = logmel([torch.from_numpy(w) for w in waves], audio, "cpu")
    batch = torch.zeros(3, 16000)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = torch.from_numpy(w)
    lens = torch.tensor([len(w) for w in waves])
    cfg = AudioConfig(**{k: v for k, v in audio.items() if k in AudioConfig.__dataclass_fields__})
    want, wn = LogMelFrontend(cfg)(batch, lens)
    fused, _ = logmel_fused_reference(batch, cfg, lens, high_precision=True)
    assert n.tolist() == wn.tolist()
    for i in range(3):
        k = int(n[i])
        torch.testing.assert_close(got[i, :k], want[i, :k], rtol=1e-4, atol=1e-4)
        assert (got[i, :k] - fused[i, :k]).abs().max() < 5e-2


def test_onecycle_matches_the_port_schedule():
    from rnntransducer_tpu_torch.config import TrainConfig
    from rnntransducer_tpu_torch.train.optim import make_schedule
    run, _ = _tiny("gru_flagship")
    sched = make_schedule(TrainConfig(**{k: v for k, v in run["train"].items()
                                         if k in TrainConfig.__dataclass_fields__}))
    for c in (0, 1, 2, 19999, 20000, 50000, 99999, 100000):
        assert onecycle_lr(run["train"], c) == pytest.approx(sched(c), rel=1e-12)


def _follow_port_steps(run, w):
    """Three fp32 AdamW steps of the port's ``train_step`` on raw int16 PCM
    and ``reference_steps`` from the same weights, the port's dropout and
    SpecAugment masks read back and handed to the reference: (readings,
    the masks of each step)."""
    from benchmark.harness.masks import MaskLog, read_back
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.data.collate import collate_waveforms
    from rnntransducer_tpu_torch.data.prefetch import to_device
    from rnntransducer_tpu_torch.train.state import TrainState, train_step
    run = copy.deepcopy(run)
    run["train"]["precision"] = "fp32"
    P = _params(run, w)
    params0 = {k: v.clone() for k, v in P.items()}
    cfg = Config.from_dict(run)
    state = TrainState.create(cfg, "cpu", state_dict=P, seed=1)
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        rows = [{"wav": (rng.randn(n) * 0.2).astype(np.float32),
                 "labels": rng.randint(4, 40, u)} for n, u in ((8000, 6), (6500, 4))]
        batches.append(rows)
    losses, grad1, masks = [], {}, []
    for k, rows in enumerate(batches):
        b = to_device(collate_waveforms(rows, 128 * 160 - 1, 8, transfer_dtype="int16"), "cpu")
        with read_back(MaskLog()) as read:
            losses.append(float(train_step(state, b)["loss"]))
        masks.append(read.as_dict())
        if k == 0:
            grad1 = {n: float(state.optimizer.state[p]["exp_avg"].double().norm()) / 0.1
                     for n, p in state.model.named_parameters()}
    change = {n: float((p.detach().double() - params0[n].double()).norm())
              for n, p in state.model.named_parameters()}
    ref = reference_steps(run, params0, batches, "cpu", masks=masks)
    return readings({"losses": losses, "grad1": grad1, "change": change}, ref), masks


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_steps_follow_the_port_fp32_steps(name):
    """Every reading small.  Not at fp32 rounding: the port's log-mel (K6's
    plain version here too) multiplies by bf16 DFT matrices, which moves the
    loss by about 1e-4 of itself.  The flagship trains with dropout and
    SpecAugment."""
    got, _ = _follow_port_steps(*_tiny(name))
    assert got["loss_rel"] < 5e-4 and got["grad1_leaf"] < 1e-2 and got["change_leaf"] < 5e-3, got


@pytest.mark.parametrize("rate,remat", [(0.1, False), (0.1, True), (26 / 256, False)])
def test_conformer_dropout_sites_follow_the_port(rate, remat):
    """The Conformer with dropout: the port draws one mask after its input
    projection and seven a block (a checkpointed block's recompute adds
    none), and the reference given them follows its steps within the GRU
    flagship's tolerances.  The port drops a whole number of 256ths: at
    0.1 it scales the kept elements by 256 / 230, the reference by 1 / 0.9,
    which moves the parameters' change by ~7e-3 after 3 steps; at 26 / 256
    the two scales are one and every reading is held."""
    from benchmark.reference.augment import share_gap, sites
    run, w = _tiny("conformer_l_stream")
    run = copy.deepcopy(run)
    run["model"]["transnet"].update(dropout=rate, remat=remat)
    got, masks = _follow_port_steps(run, w)
    enc_sites = sites(run["model"])[0]
    assert len(enc_sites) == 1 + 7 * run["model"]["transnet"]["num_layers"]
    assert all(len(m["dropout"]) == len(enc_sites) for m in masks)
    assert share_gap(masks, run) < 1.0   # the masks fit the sites (tiny masks' shares swing)
    assert got["loss_rel"] < 5e-4 and got["grad1_leaf"] < 1e-2, got
    if float(rate * 256).is_integer():
        assert got["change_leaf"] < 5e-3, got


def test_walk_reads_zero_on_the_port_greedy_and_catches_an_altered_token():
    from rnntransducer_tpu_torch.decode.greedy import greedy_decode_with_times
    run, w = _tiny("gru_flagship")
    P = _params(run, w)
    port = _port(run, P)
    ref = Reference(run["model"], P)
    feats, lens, _, _ = _batch(run)
    with torch.no_grad():
        toks, n, times = greedy_decode_with_times(port, feats, lens, max_symbols=3,
                                                  max_output_len=512)
        enc, el = ref.encode(feats, lens)
        A = ref.enc_factor(enc).double().numpy()
    emitted = 0
    for i in range(len(lens)):
        k = int(n[i])
        emitted += k
        y, t = toks[i, :k].tolist(), times[i, :k].tolist()
        gap, path = walk(ref, A[i, :int(el[i])], y, t, 3, 1.0, "cpu")
        assert gap < 1e-4 and path is not None
        if k:
            bad = list(y)
            bad[k // 2] = 4 + (bad[k // 2] + 1 - 4) % 36
            if k // 2 > 0 and bad[k // 2] == bad[k // 2 - 1]:
                bad[k // 2] = 4 + (bad[k // 2] + 1 - 4) % 36
            assert walk(ref, A[i, :int(el[i])], bad, t, 3, 1.0, "cpu")[0] > 1e-3
    assert emitted > 0
