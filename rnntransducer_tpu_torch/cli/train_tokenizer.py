"""Train a subword (BPE) tokenizer from transcripts (the port's counterpart
of the JAX package's ``scripts/train_tokenizer.py``, with its flags and
output).

The result is one JSON file that every CLI takes through ``--vocab_path``
(or ``config.vocab_path``; the format is sniffed).  Set
``model.jointnet.num_classes`` and ``model.prednet.embedding_size`` to the
vocabulary size it prints.

Input: a text file with one transcript per line (``--text``), or a
``wav_path<TAB>transcript`` manifest (``--manifest``, the format of
``cli.prepare_manifest``).  Host text processing only: it has no
``--device`` flag.

Example:
  python -m rnntransducer_tpu_torch.cli.train_tokenizer --text corpus.txt \\
      --vocab_size 1024 --out bpe_1024.json
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--text", help="one transcript per line")
    src.add_argument("--manifest", help="wav_path<TAB>transcript TSV")
    p.add_argument("--vocab_size", type=int, required=True)
    p.add_argument("--normalize", default="jamo", choices=["jamo", "none"],
                   help="'jamo' decomposes Hangul first (the data-prep "
                        "convention); 'none' models raw text")
    p.add_argument("--out", required=True, help="output tokenizer JSON")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from rnntransducer_tpu_torch.tokenizer import train_bpe

    def lines():
        with open(args.text or args.manifest) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if args.manifest:
                    parts = line.split("\t", 1)
                    if len(parts) != 2:
                        continue
                    line = parts[1]
                yield line

    tok = train_bpe(lines(), args.vocab_size, normalize=args.normalize)
    tok.save(args.out)
    print(f"trained {len(tok)} pieces ({len(tok.merges)} merges) -> "
          f"{args.out}; set model.jointnet.num_classes = "
          f"model.prednet.embedding_size = {len(tok)}")


if __name__ == "__main__":
    main()
