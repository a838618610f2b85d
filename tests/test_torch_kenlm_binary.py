"""The port's KenLM binary tools (utils/kenlm_binary.py, cli/convert_lm.py)
against the JAX package's (``rnntransducer_tpu/utils/kenlm_binary.py``,
``scripts/convert_lm.py``) on ``tests/test_beam_lm.py``'s ARPA and an
order-3 ARPA with patched interior n-grams and a -0.0 backoff: PROBING,
TRIE and quantized TRIE files byte-equal (the reference's two quantizer
choices included), the trie reader's round trip equal, the port's
``decode/ngram_lm`` scoring each unquantized binary as its ARPA, and the
CLI's files byte-equal to the script's, each run as a subprocess."""

import itertools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rnntransducer_tpu.utils import kenlm_binary as jax_kenlm

from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
from rnntransducer_tpu_torch.utils import kenlm_binary

from test_beam_lm import ARPA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# order 3; "<s> dog" and "the cat" are no bigrams of their own (the trie
# writer patches them in at KLOG_ZERO), "the cat" backs off with -0.0
ARPA3 = textwrap.dedent(r"""
\data\
ngram 1=6
ngram 2=4
ngram 3=3

\1-grams:
-1.0    <s>    -0.5
-1.0    </s>
-0.6    the    -0.3
-1.2    cat    -0.2
-1.4    dog    -0.25
-2.0    <unk>

\2-grams:
-0.3    <s> the    -0.1
-0.4    the cat    -0.0
-0.9    the dog
-0.5    cat </s>    -0.2

\3-grams:
-0.2    <s> the cat
-0.7    the cat </s>
-1.1    <s> dog the

\end\
""").strip()

LMS = {"arpa2": ARPA, "arpa3": ARPA3}
WRITERS = {"probing": ("write_probing_binary", {}),
           "trie": ("write_trie_binary", {}),
           "trie_q8": ("write_trie_binary", {"quant_bits": (8, 8)}),
           "trie_q2": ("write_trie_binary", {"quant_bits": (2, 3)})}


def _write(module, kind, text, path):
    name, kw = WRITERS[kind]
    getattr(module, name)(text, str(path), **kw)
    return open(path, "rb").read()


@pytest.mark.parametrize("lm", sorted(LMS))
@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_writers_are_byte_equal(tmp_path, lm, kind):
    got = _write(kenlm_binary, kind, LMS[lm], tmp_path / "port.bin")
    want = _write(jax_kenlm, kind, LMS[lm], tmp_path / "jax.bin")
    assert len(got) > 100 and got == want


@pytest.mark.parametrize("lm", sorted(LMS))
@pytest.mark.parametrize("kind", ["trie", "trie_q8"])
def test_trie_reader_round_trip(tmp_path, lm, kind):
    path = tmp_path / "lm.trie"
    _write(kenlm_binary, kind, LMS[lm], path)
    order, counts, grams, vocab = kenlm_binary.read_trie_binary(str(path))
    assert (order, counts, grams, vocab) == jax_kenlm.read_trie_binary(str(path))
    src_order, src_counts, src = kenlm_binary.parse_arpa(LMS[lm])
    assert order == src_order
    source = {n: {tuple(w): (p, b) for w, p, b in src[n]} for n in src}
    for n in range(1, order + 1):
        kept = [(w, p, b) for w, p, b in grams[n] if tuple(w) in source[n]]
        # the rest are interior n-grams the writer patched in
        assert all(p <= -98.0 for w, p, b in grams[n] if tuple(w) not in source[n])
        assert len(kept) == src_counts[n - 1] and len(grams[n]) == counts[n - 1]
        for w, p, b in kept:
            np.testing.assert_allclose((p, b), source[n][tuple(w)], atol=1e-6)
    assert (lm == "arpa3") == (counts != src_counts)


@pytest.mark.parametrize("lm", sorted(LMS))
@pytest.mark.parametrize("kind", ["probing", "trie"])
def test_the_port_reader_scores_each_binary_as_its_arpa(tmp_path, lm, kind):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(LMS[lm])
    _write(kenlm_binary, kind, LMS[lm], tmp_path / "lm.bin")
    lm_a = NGramLM.load(str(arpa), weight=1.0, beta=0.0)
    lm_b = NGramLM.load(str(tmp_path / "lm.bin"), weight=1.0, beta=0.0)
    assert lm_a.order == lm_b.order
    words = ["<s>", "</s>", "the", "cat", "dog", "<unk>"]
    for ctx in itertools.chain([()], itertools.product(words, repeat=lm_a.order - 1)):
        for w in words:
            ca = tuple(lm_a.word_id(x) for x in ctx)
            cb = tuple(lm_b.word_id(x) for x in ctx)
            np.testing.assert_allclose(lm_b.raw_score(cb, lm_b.word_id(w)),
                                       lm_a.raw_score(ca, lm_a.word_id(w)), atol=1e-6,
                                       err_msg=f"P({w} | {ctx})")


def test_cli_equals_the_script(tmp_path):
    """Each conversion through ``python -m rnntransducer_tpu_torch.cli.
    convert_lm`` and ``scripts/convert_lm.py``: the same files byte for
    byte, the same output and the same refusals."""
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA3)
    src = {"arpa": arpa}
    for kind in ("trie", "trie_q8", "probing"):
        src[kind] = tmp_path / f"src.{kind}"
        _write(jax_kenlm, kind, ARPA3, src[kind])
    cases = [("arpa", "probing", []), ("arpa", "trie", []),
             ("arpa", "trie", ["--quant", "8", "8"]), ("trie", "arpa", []),
             ("trie_q8", "arpa", []), ("trie", "probing", []),
             ("probing", "arpa", []), ("arpa", "probing", ["--quant", "8", "8"])]
    tools = (("port", [sys.executable, "-m", "rnntransducer_tpu_torch.cli.convert_lm"]),
             ("jax", [sys.executable, os.path.join(REPO, "scripts", "convert_lm.py")]))
    out = {}
    for first in range(0, len(cases), 4):  # 8 processes at a time
        runs = {}
        for i in range(first, min(first + 4, len(cases))):
            frm, to, extra = cases[i]
            for tool, cmd in tools:
                dst = tmp_path / f"{tool}{i}.{to}"
                runs[tool, i] = (dst, subprocess.Popen(
                    cmd + [str(src[frm]), str(dst), "--to", to] + extra, cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for key, (dst, proc) in runs.items():
            stdout, stderr = proc.communicate(timeout=120)
            data = open(dst, "rb").read() if dst.exists() else None
            out[key] = (proc.returncode, stdout.replace(str(dst), "DST"),
                        stderr.strip().splitlines()[-1:], data)
    for i, (frm, to, extra) in enumerate(cases):
        assert out["port", i] == out["jax", i], (frm, to, extra)
        refused = frm == "probing" or (extra and to != "trie")
        assert (out["port", i][0] != 0) == bool(refused), (frm, to, out["port", i])
    assert out["port", 2][3] == _write(kenlm_binary, "trie_q8", ARPA3, tmp_path / "q")
