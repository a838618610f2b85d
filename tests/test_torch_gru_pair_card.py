"""K2's paired backward on the card: both directions of a bidirectional GRU
layer in one launch against two single K2 launches.  A ``cuda`` test: it
skips without a card.  This file imports no JAX (the card's machine has
none); the pair's routing and its plain version are tested on the CPU in
``test_torch_gru_persistent.py`` and ``test_torch_rnn_backward.py``."""

import pytest
import torch


@pytest.mark.cuda
def test_pair_equals_two_single_launches_on_the_card():
    """``chip_smoke.phase_gru_pair``: dxw, dnr and dh0 of both directions bit
    for bit against two single launches (fp32 and bf16; B 1, 64, 96; T 1,
    512; ragged lengths; H=1024), 2 launches a pair; then the pair's time at
    B=64, T=512 beside the two single calls'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    times = chip_smoke.phase_gru_pair(
        torch.Generator(device=chip_smoke.DEVICE).manual_seed(chip_smoke.SEED))
    for dtype in ("bfloat16", "float32"):
        assert times[dtype]["pair_ms"] > 0 and times[dtype]["two_singles_ms"] > 0
