"""Convert language-model artifacts between the formats the decoders load
(port of ``scripts/convert_lm.py``, the same arguments and byte-equal
output).

The port's ``decode/ngram_lm.py`` reads ARPA, PROBING and TRIE binaries
(unquantized and quantized -q) natively.  This tool covers the remaining
interchange cases, dependency-free:

    python -m rnntransducer_tpu_torch.cli.convert_lm lm.arpa lm.bin --to probing
    python -m rnntransducer_tpu_torch.cli.convert_lm lm.arpa lm.trie --to trie
    python -m rnntransducer_tpu_torch.cli.convert_lm lm.arpa lm.qtrie --to trie --quant 8 8
    python -m rnntransducer_tpu_torch.cli.convert_lm lm.trie lm.arpa --to arpa

PROBING binaries cannot be converted back to ARPA: the probing layout
stores only 64-bit hashes of the n-gram id sequences, so the n-grams are
unrecoverable; convert from the original ARPA or a trie binary instead.
"""

from __future__ import annotations

import argparse
import gzip
import struct
import sys

from rnntransducer_tpu_torch.utils.kenlm_binary import (read_trie_binary,
                                                        write_probing_binary,
                                                        write_trie_binary)


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _sniff(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    if head != b"mmap lm ":
        return "arpa"
    with open(path, "rb") as f:
        f.seek(88)
        raw = f.read(4)
    if len(raw) < 4:
        sys.exit(f"{path}: truncated/corrupt kenlm binary (header shorter "
                 "than 92 bytes)")
    model_type, = struct.unpack("<i", raw)
    return {0: "probing", 2: "trie"}.get(model_type, f"type{model_type}")


# interior trie nodes that never appeared in the source ARPA are patched in
# with prob ~KLOG_ZERO (-99) by the trie writer; a faithful ARPA round trip
# must drop them again (a real kenlm would otherwise treat them as genuine
# n-grams)
_PATCHED_PROB_CEILING = -98.0


def _grams_to_arpa(order, counts, grams) -> str:
    kept = {n: [(w, p, b) for (w, p, b) in grams[n]
                if p > _PATCHED_PROB_CEILING]
            for n in range(1, order + 1)}
    lines = ["\\data\\"]
    lines += [f"ngram {n}={len(kept[n])}" for n in range(1, order + 1)]
    for n in range(1, order + 1):
        lines += ["", f"\\{n}-grams:"]
        for words, prob, backoff in kept[n]:
            # %.9g is float32-round-trip exact (the binary stores f32)
            row = f"{prob:.9g}\t{' '.join(words)}"
            if n < order and backoff != 0.0:
                row += f"\t{backoff:.9g}"
            lines.append(row)
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--to", choices=("arpa", "probing", "trie"),
                   required=True)
    p.add_argument("--quant", nargs=2, type=int, metavar=("PROB_BITS",
                                                          "BACKOFF_BITS"),
                   help="with --to trie: write a QUANT_TRIE (model_type 3, "
                        "kenlm `build_binary -q P -b B trie` equivalent); "
                        "e.g. --quant 8 8")
    args = p.parse_args(argv)
    if args.quant and args.to != "trie":
        sys.exit("--quant only applies to --to trie")

    fmt = _sniff(args.src)
    if fmt == "arpa":
        text = _read_text(args.src)
    elif fmt in ("trie", "type3"):
        # model_type 3 = QUANT_TRIE: same reader, bins decoded to floats
        order, counts, grams, _ = read_trie_binary(args.src)
        text = _grams_to_arpa(order, counts, grams)
    elif fmt == "probing":
        sys.exit("probing binaries store only n-gram hashes — the n-grams "
                 "are unrecoverable; convert from the original ARPA or a "
                 "trie binary")
    else:
        sys.exit(f"unsupported kenlm model type in {args.src} ({fmt}); "
                 "bhiksha-array tries must be rebuilt without -a")

    if args.to == "arpa":
        with open(args.dst, "w") as f:
            f.write(text)
    elif args.to == "probing":
        write_probing_binary(text, args.dst)
    else:
        write_trie_binary(text, args.dst,
                          quant_bits=tuple(args.quant) if args.quant
                          else None)
    print(f"{args.src} ({fmt}) -> {args.dst} ({args.to}"
          + (f" -q {args.quant[0]} -b {args.quant[1]}" if args.quant
             else "") + ")")


if __name__ == "__main__":
    main()
