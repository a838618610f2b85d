"""The port's WER / CER (train/metrics.py) against the JAX package's, on
seeded random strings, Hangul included: exact."""

import numpy as np
import pytest

from rnntransducer_tpu.train import metrics as jax_metrics
from rnntransducer_tpu_torch.train import metrics

# Latin letters, Hangul syllables and jamo, digits, with spaces for words
ALPHABET = (list("abcdefg") + list("가나다라마바사아자") + list("ㄱㄴㅏㅓ")
            + list("019"))


def _strings(rng, n):
    out = []
    for _ in range(n):
        words = [
            "".join(rng.choice(ALPHABET, size=rng.randint(1, 6)))
            for _ in range(rng.randint(0, 6))]
        out.append(" ".join(words))
    return out


def _pairs(seed, n=40):
    rng = np.random.RandomState(seed)
    refs = _strings(rng, n)
    preds = []
    for r in refs:
        chars = list(r)
        for _ in range(rng.randint(0, 4)):  # substitute, insert, delete
            op = rng.randint(3)
            i = rng.randint(len(chars) + 1)
            if op == 0 and chars:
                chars[min(i, len(chars) - 1)] = rng.choice(ALPHABET)
            elif op == 1:
                chars.insert(i, rng.choice(ALPHABET + [" "]))
            elif chars:
                del chars[min(i, len(chars) - 1)]
        preds.append("".join(chars))
    return preds, refs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_error_counts_and_rates_match_the_jax_package(seed):
    preds, refs = _pairs(seed)
    assert metrics.error_counts(preds, refs) == jax_metrics.error_counts(preds, refs)
    assert metrics.word_error_rate(preds, refs) == jax_metrics.word_error_rate(preds, refs)
    assert metrics.char_error_rate(preds, refs) == jax_metrics.char_error_rate(preds, refs)


def test_edit_distance_edge_cases():
    for ref, hyp in (("", ""), ("", "가나"), ("가나", ""), ("kitten", "sitting"),
                     ("가나다", "가다")):
        assert (metrics.edit_distance(list(ref), list(hyp))
                == jax_metrics.edit_distance(list(ref), list(hyp)))
    assert metrics.edit_distance(list("kitten"), list("sitting")) == 3
    assert metrics.word_error_rate([], []) == 0.0
