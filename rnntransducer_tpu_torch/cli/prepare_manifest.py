"""Raw PCM shards from a ``wav_path<TAB>transcript`` manifest: the first
step from a corpus to a trained model (the port's counterpart of the JAX
package's ``scripts/prepare_manifest.py``, with its flags and output).

Korean transcripts are decomposed to compatibility jamo and encoded with the
72-entry grapheme vocabulary (or ``--vocab_path``).  Rows whose line is
malformed or whose WAV cannot be read are skipped with a ``[skip]`` line;
rows with no samples or no tokens are skipped silently.  The shards land
under ``<out>/<split>/<i>`` with the columns ``input_values`` (float32 PCM)
and ``input_ids``.

This is host IO (WAV reads, tokenization, Arrow writes) in both packages
and touches no device, so it has no ``--device`` flag: nothing here runs on
a CPU in place of the card.

Example:
  python -m rnntransducer_tpu_torch.cli.prepare_manifest --manifest train.tsv \\
      --out /data/raw --split train --num_shards 4
  # then: python -m rnntransducer_tpu_torch.cli.train --hf_data_dirs /data/raw \\
  #     --pl_data_dir /data/logmel ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", required=True,
                   help="TSV: wav_path<TAB>transcript per line")
    p.add_argument("--out", required=True, help="output dataset root")
    p.add_argument("--split", default="train",
                   choices=["train", "dev", "eval_clean", "eval_other"])
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--sample_rate", type=int, default=16000)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Write the shards; returns the number of utterances written."""
    args = parse_args(argv)

    from datasets import Dataset

    from rnntransducer_tpu_torch.tokenizer import decompose_hangul, load_tokenizer
    from rnntransducer_tpu_torch.utils.audio_io import read_wav

    tok = load_tokenizer(args.vocab_path, 72)

    wavs, ids, skipped = [], [], 0
    with open(args.manifest) as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            try:
                path, text = line.split("\t", 1)
                wav = read_wav(path, args.sample_rate)
                token_ids = tok.encode(decompose_hangul(text.strip()))
            except Exception as e:  # a malformed row: skip it loudly, go on
                print(f"[skip] line {ln}: {e}")
                skipped += 1
                continue
            if len(wav) == 0 or len(token_ids) == 0:
                skipped += 1
                continue
            wavs.append(np.asarray(wav, np.float32))
            ids.append(token_ids)

    if not wavs:
        raise SystemExit("no usable utterances in the manifest")
    ds = Dataset.from_dict({"input_values": wavs, "input_ids": ids})
    for i in range(args.num_shards):
        shard = ds.shard(num_shards=args.num_shards, index=i)
        shard.save_to_disk(os.path.join(args.out, args.split, str(i)))
    print(f"wrote {len(ds)} utterances ({skipped} skipped) to "
          f"{args.out}/{args.split}/ in {args.num_shards} shard(s)")
    return len(ds)


if __name__ == "__main__":
    main()
