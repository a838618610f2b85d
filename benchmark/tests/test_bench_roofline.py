"""The benchmark's copies of the FLOP and byte arithmetic against the
originals in chip_smoke.py, at the bring-up's shapes."""

import pytest
import torch

from benchmark.harness.common import BENCH_DIR, load_json
from benchmark.roofline import counts
from benchmark.roofline.encoders.conformer import conformer_step_flops
from benchmark.roofline.encoders.rnn import rnn_step_flops


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def _flagship():
    return load_json(BENCH_DIR / "configs" / "gru_flagship.json")["run"]["model"]


def test_flagship_padded_step_flops_equal_chip_smoke(smoke):
    from rnntransducer_tpu_torch.config import base_config
    want = smoke.step_model_flops(base_config(), 64, 512, 48)
    assert rnn_step_flops(_flagship(), 64, 512, 48) == pytest.approx(want, rel=1e-12)
    # per row at full length sums to the padded batch
    assert counts.train_step_flops(_flagship(), [512] * 64, [48] * 64) == pytest.approx(
        want, rel=1e-12)


def test_conformer_padded_step_flops_equal_chip_smoke(smoke):
    model = load_json(BENCH_DIR / "configs" / "conformer_l_stream.json")["run"]["model"]
    cfg = smoke.streaming_conformer_config()
    import dataclasses
    tn = dataclasses.replace(cfg.model.transnet, num_layers=17, conv_kernel_size=32)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, transnet=tn))
    want = smoke.conformer_step_flops(cfg, 64, 512, 48)
    got = conformer_step_flops(model, 64, 512, 48, padded=True)
    assert got == pytest.approx(want, rel=1e-12)
    # the chunked window attends fewer pairs than T'^2
    assert conformer_step_flops(model, 64, 512, 48) < got


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_kernel_bounds_equal_chip_smoke(smoke, dtype):
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    lengths = torch.tensor([512, 400, 300, 511, 64, 1, 256, 512] * 8)
    for T, B, H in ((512, 64, 1024), (512, 8, 1024), (512, 1, 1024)):
        ln = lengths[:B]
        assert counts.gru_bound_ms(T, B, H, dtype, ln.tolist()) == pytest.approx(
            smoke.gru_bound_ms(T, B, H, tdt, ln))
        assert counts.gru_bwd_bound_ms(T, B, H, dtype, ln.tolist()) == pytest.approx(
            smoke.gru_bwd_bound_ms(T, B, H, tdt, ln))
    for T, B, H in ((49, 64, 1024), (512, 8, 320), (512, 64, 320)):
        ln = torch.clamp(lengths[:B], max=T)
        for bwd in (False, True):
            assert counts.lstm_bound_ms(T, B, H, dtype, ln.tolist(), bwd) == pytest.approx(
                smoke.lstm_bound_ms(T, B, H, tdt, ln, bwd))
    assert counts.sweep_bound_ms(64, 512, 49) == pytest.approx(smoke.sweep_bound_ms(64, 512, 49))
    for high in (False, True):
        assert counts.logmel_bound_ms(32768, 400, 201, 80, high) == pytest.approx(
            smoke.logmel_bound_ms(32768, 400, 201, 80, high))


def test_decode_flops_count_the_encoder_once():
    m = _flagship()
    enc_only = counts.decode_flops(m, 100, 0)
    assert enc_only == pytest.approx(rnn_step_flops(m, 1, 100, -1) / 3.0
                                     - (2 * 0 * 512 * 72), rel=1e-2)
