"""Guards of the PyTorch port: it stands apart from the JAX package, its
entry points never fall back to the CPU unasked, and its CUDA wrapper never
falls back to the plain version."""

import ast
import os

import numpy as np
import pytest
import torch

from rnntransducer_tpu_torch import Recognizer, build_model, tiny_config
from rnntransducer_tpu_torch.ops import build, rnn_kernels
from rnntransducer_tpu_torch.tokenizer import GraphemeTokenizer
from rnntransducer_tpu_torch.utils.weights import random_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "rnntransducer_tpu")


def _port_sources():
    root = os.path.join(REPO, "rnntransducer_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_scan_covers_the_training_loop_and_cli():
    """The modules of the training loop, the data feed, the decoders, the
    train and inference CLIs, session serving, corpus evaluation, the
    reference-checkpoint import, the Conformer, the optimizers, the data
    axis, the manifest and tokenizer tools, the debugging tools, the
    kernels' op registrations, the deployment bundles, the params-bundle
    codec and the KenLM tools are among those scanned, and each imports the
    port's own copies."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    pkg = "rnntransducer_tpu_torch"
    for mod in ("train/metrics.py", "train/checkpoint.py", "train/loop.py",
                "data/bucketing.py", "data/collate.py", "data/dataset.py",
                "data/prefetch.py", "utils/logging.py", "utils/profiling.py",
                "cli/train.py", "cli/__init__.py", "cli/infer.py", "serve.py",
                "decode/__init__.py", "decode/beam.py", "decode/beam_batched.py",
                "decode/device_lm.py", "decode/device_word_lm.py",
                "decode/greedy.py", "decode/hotwords.py", "decode/ngram_lm.py",
                "decode/streaming.py", "decode/session_batch.py", "serve_socket.py",
                "eval.py", "cli/evaluate.py", "utils/torch_import.py",
                "models/conformer.py", "models/transducer.py", "train/optim.py",
                "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
                "parallel/pipeline.py", "parallel/wavefront.py",
                "cli/prepare_manifest.py", "cli/train_tokenizer.py",
                "utils/debugging.py", "ops/library.py", "utils/export.py",
                "utils/flax_msgpack.py", "utils/weights.py", "utils/kenlm_binary.py",
                "cli/convert_lm.py"):
        path = os.path.join(pkg, mod)
        assert path in scanned, path
        own = [m for m in _imported_modules(os.path.join(REPO, path))
               if m.startswith("rnntransducer")]
        assert all(m.split(".")[0] == pkg for m in own), (path, own)
    assert not os.path.exists(os.path.join(REPO, "train_torch.py"))


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Without CUDA every entry point raises unless asked for the CPU: the
    model and the Recognizer, and through them the batched runner, the
    socket server and corpus evaluation (each runs on its model's device);
    the serving and evaluation CLIs and the checkpoint conversion."""
    from rnntransducer_tpu_torch import serve_socket
    from rnntransducer_tpu_torch.cli import evaluate
    from rnntransducer_tpu_torch.train.checkpoint import CheckpointManager
    from rnntransducer_tpu_torch.train.state import TrainState
    from rnntransducer_tpu_torch.utils import torch_import

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    params = random_flax_params(cfg.model, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recognizer(cfg, params, GraphemeTokenizer.default(72))
    assert next(build_model(cfg, "cpu").parameters()).device.type == "cpu"
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(1, TrainState.create(cfg, "cpu"), config=cfg)
    mgr.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_socket.main(["--checkpoint_dir", ckpt, "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--checkpoint_dir", ckpt, "--manifest", "unused.tsv"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_import.convert_to_checkpoint("unread.ckpt", cfg, str(tmp_path / "out"))
    # a Conformer config lands on CUDA by default too
    import dataclasses
    conf = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transnet=dataclasses.replace(
            cfg.model.transnet, arch="conformer", hidden_size=32, attention_heads=4,
            num_layers=1, bidirectional=False, attention_chunk=4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainState.create(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recognizer(conf, random_flax_params(conf.model, torch.Generator().manual_seed(0)),
                   GraphemeTokenizer.default(72))
    model = build_model(conf, "cpu")
    assert type(model.encoder).__name__ == "ConformerEncoder"


def _gru_args(device="cpu"):
    rng = np.random.RandomState(0)
    T, B, H = 3, 2, 8
    xw = torch.from_numpy(rng.randn(T, B, 3 * H).astype(np.float32))
    w = torch.from_numpy(rng.randn(H, 3 * H).astype(np.float32))
    b = torch.zeros(3 * H)
    h0 = torch.zeros(B, H)
    lengths = torch.tensor([3, 1])
    return [a.to(device) for a in (xw, w, b, h0, lengths)]


def test_cuda_gru_wrapper_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The kernel path, given tensors on a machine without nvcc, raises: it
    never hands the work to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    before = rnn_kernels.gru_scan.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rnn_kernels._gru_scan_cuda(*_gru_args(), False)
    assert rnn_kernels.gru_scan.launches == before


def test_gru_wrapper_checks_its_inputs():
    xw, w, b, h0, lengths = _gru_args()
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rnn_kernels.gru_scan(xw.to("meta"), w, b, h0, lengths)
    with pytest.raises(ValueError, match="do not agree"):
        rnn_kernels._gru_scan_cuda(xw, w[:, :-3], b, h0, lengths, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rnn_kernels._gru_scan_cuda(xw.half(), w, b, h0, lengths, False)
    with pytest.raises(TypeError, match="one dtype"):
        rnn_kernels._gru_scan_cuda(xw, w.to(torch.bfloat16), b, h0, lengths, False)
    with pytest.raises(ValueError, match="contiguous"):
        rnn_kernels._gru_scan_cuda(xw.transpose(0, 1).contiguous().transpose(0, 1),
                                   w, b, h0, lengths, False)


def test_weight_tiles_hold_each_blocks_gate_columns():
    """The kernel's weight layout: block i, row g*jt + jj, column k holds
    W_hh[k, g*H + i*jt + jj], zero where k or j is padding."""
    H, Hk, jt = 12, 64, 8
    w = torch.arange(H * 3 * H, dtype=torch.float32).view(H, 3 * H)
    tiles = rnn_kernels._tile_weights(w, H, Hk, jt)
    assert tiles.shape == (2, 3 * jt, Hk)
    for i in range(2):
        for g in range(3):
            for jj in range(jt):
                j = i * jt + jj
                col = tiles[i, g * jt + jj]
                if j < H:
                    assert torch.equal(col[:H], w[:, g * H + j])
                else:
                    assert not col.any()
                assert not col[H:].any()


@pytest.mark.cuda
def test_gru_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(1)
    T, B, H = 40, 5, 96
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for reverse in (False, True):
            xw = torch.randn(T, B, 3 * H, generator=gen).to("cuda", dtype)
            w = (torch.randn(H, 3 * H, generator=gen) * 0.1).to("cuda", dtype)
            b = (torch.randn(3 * H, generator=gen) * 0.1).to("cuda", dtype)
            h0 = torch.randn(B, H, generator=gen).to("cuda", dtype)
            lengths = torch.tensor([T, 17, 1, 40, 9], device="cuda")
            got = rnn_kernels.gru_scan(xw, w, b, h0, lengths, reverse)
            want = rnn_kernels.gru_scan_reference(xw, w, b, h0, lengths, reverse)
            for g, r in zip(got, want):
                assert (g.float() - r.float()).abs().max().item() <= tol


@pytest.mark.parametrize("library", ["lstm_fwd", "lstm_bwd", "logmel"])
def test_new_kernel_libraries_raise_without_nvcc(monkeypatch, tmp_path, library):
    """Each kernel of the LSTM and raw-PCM paths is built at first use; on a
    machine without nvcc that raises, so a wrapper never falls back."""
    from rnntransducer_tpu_torch.frontend import fused_frontend
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    load = {"lstm_fwd": rnn_kernels._lstm_fwd_library,
            "lstm_bwd": rnn_kernels._lstm_bwd_library,
            "logmel": fused_frontend._library}[library]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        load()
    if library == "lstm_fwd":
        xw, w, b, h0, c0, lengths = _lstm_args()
        before = rnn_kernels.lstm_scan.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            rnn_kernels._lstm_scan_cuda(xw, w, b, h0, c0, lengths, False)
        assert rnn_kernels.lstm_scan.launches == before


def _lstm_args():
    rng = np.random.RandomState(0)
    T, B, H = 3, 2, 8
    xw = torch.from_numpy(rng.randn(T, B, 4 * H).astype(np.float32))
    w = torch.from_numpy(rng.randn(H, 4 * H).astype(np.float32))
    return xw, w, torch.zeros(4 * H), torch.zeros(B, H), torch.zeros(B, H), \
        torch.tensor([3, 1])


def test_lstm_wrappers_check_their_inputs():
    xw, w, b, h0, c0, lengths = _lstm_args()
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rnn_kernels.lstm_scan(xw.to("meta"), w, b, h0, c0, lengths)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rnn_kernels.lstm_scan_backward(xw.to("meta"), h0, c0, w, b, lengths,
                                       h0, h0, h0)
    with pytest.raises(ValueError, match="must be \\(T, B, 4H\\)"):
        rnn_kernels._lstm_scan_cuda(xw[..., :-1], w, b, h0, c0, lengths, False)
    with pytest.raises(ValueError, match="w_hh has shape"):
        rnn_kernels._lstm_scan_cuda(xw, w[:, :-4], b, h0, c0, lengths, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rnn_kernels._lstm_scan_cuda(xw.half(), w, b, h0, c0, lengths, False)
    with pytest.raises(TypeError, match="in xw's dtype"):
        rnn_kernels._lstm_scan_cuda(xw, w.to(torch.bfloat16), b, h0, c0, lengths,
                                    False)
    with pytest.raises(ValueError, match="contiguous"):
        rnn_kernels._lstm_scan_cuda(xw, w.t().contiguous().t(), b, h0, c0,
                                    lengths, False)
