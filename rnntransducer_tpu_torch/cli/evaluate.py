"""Corpus evaluation CLI of the port: checkpoint + test set -> CER / WER /
RTF, with the flags and checks of the JAX package's ``evaluate.py`` plus
``--device`` (default cuda; ``--device cpu`` asks for the CPU).

Inputs: a ``wav<TAB>transcript`` TSV manifest (the
``scripts/prepare_manifest.py`` format) or a prepared Arrow dataset dir +
split.  Decoders: greedy, the device beam (``beam_batched``, optionally with
an on-device char LM through ``--device_lm``), or the host A/B beam with
word-level LM + hotwords.

Examples:
  python -m rnntransducer_tpu_torch.cli.evaluate --checkpoint_dir ckpts \\
      --manifest eval.tsv
  python -m rnntransducer_tpu_torch.cli.evaluate --checkpoint_dir ckpts \\
      --data_dir /data/raw --split eval_clean --decoder beam \\
      --lm_path lm.arpa --dump per_utt.jsonl
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--average_k", type=int, default=None,
                   help="evaluate the mean of the best K checkpoints")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA shadow params")
    p.add_argument("--manifest", type=str, default=None,
                   help="TSV: wav_path<TAB>transcript per line")
    p.add_argument("--data_dir", type=str, nargs="+", default=None,
                   help="prepared Arrow dataset root(s) (log-mel or raw-PCM)")
    p.add_argument("--split", type=str, default="eval_clean")
    p.add_argument("--max_utts", type=int, default=None)
    p.add_argument("--vocab_path", type=str, default=None)
    p.add_argument("--decoder", type=str, default="greedy",
                   choices=["greedy", "beam", "beam_batched"])
    p.add_argument("--beam_width", type=int, default=None)
    p.add_argument("--improved", action="store_true", default=None)
    p.add_argument("--no-improved", dest="improved", action="store_false")
    p.add_argument("--state_beam", type=float, default=None)
    p.add_argument("--expand_beam", type=float, default=None)
    p.add_argument("--lm_path", type=str, default=None)
    p.add_argument("--lm_weight", type=float, default=None)
    p.add_argument("--hotwords", type=str, nargs="*", default=None)
    p.add_argument("--hotword_weight", type=float, default=None)
    p.add_argument("--device_lm", type=str, default=None,
                   help="char n-gram ARPA fused on the device inside the "
                        "batched beam (--decoder beam_batched)")
    p.add_argument("--device_lm_weight", type=float, default=0.3)
    p.add_argument("--device_lm_order", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--frame_bucket", type=int, default=128,
                   help="pad decode batches to multiples of this many frames")
    p.add_argument("--max_output_len", type=int, default=256)
    p.add_argument("--precision", choices=("fp32", "bf16"), default=None,
                   help="decode compute dtype (beam scores stay fp32); "
                        "default keeps the checkpoint's dtype")
    p.add_argument("--oracle_nbest", action="store_true",
                   help="with a beam decoder: also report the oracle CER (the "
                        "best hypothesis of each n-best list), which separates "
                        "search errors from model errors")
    p.add_argument("--dump", type=str, default=None,
                   help="write per-utterance {id, ref, hyp, cer, wer} jsonl")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; prints and returns the summary."""
    args = parse_args(argv)
    if bool(args.manifest) == bool(args.data_dir):
        raise SystemExit("pass exactly one of --manifest / --data_dir")
    if args.device_lm and args.decoder != "beam_batched":
        raise SystemExit("--device_lm requires --decoder beam_batched")
    if (args.lm_path or args.hotwords) and args.decoder != "beam":
        raise SystemExit("--lm_path/--hotwords require --decoder beam")
    if args.oracle_nbest and args.decoder == "greedy":
        raise SystemExit("--oracle_nbest requires a beam decoder")

    from rnntransducer_tpu_torch.eval import (evaluate_corpus, load_dataset_items,
                                              load_manifest_items,
                                              write_per_utt_jsonl)
    from rnntransducer_tpu_torch.models.transducer import build_model
    from rnntransducer_tpu_torch.tokenizer import load_tokenizer
    from rnntransducer_tpu_torch.train.checkpoint import (load_config,
                                                          load_decode_params)
    from rnntransducer_tpu_torch.utils.device import resolve_device

    cfg = load_config(args.checkpoint_dir)
    inf = cfg.inference
    pick = lambda flag, cfg_val: cfg_val if flag is None else flag
    args.beam_width = pick(args.beam_width, inf.beam_width)
    args.improved = pick(args.improved, inf.improved)
    args.state_beam = pick(args.state_beam, inf.state_beam)
    args.expand_beam = pick(args.expand_beam, inf.expand_beam)
    device = resolve_device(args.device)
    tok = load_tokenizer(args.vocab_path or cfg.vocab_path,
                         cfg.model.jointnet.num_classes)
    try:
        params, picked = load_decode_params(
            args.checkpoint_dir, cfg, step=args.step, average_k=args.average_k,
            use_ema=args.use_ema)
    except ValueError as e:
        raise SystemExit(str(e))
    model = build_model(cfg, device, state_dict=params)

    lm = None
    if args.lm_path:
        from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
        lm = NGramLM.load(args.lm_path, weight=args.lm_weight)
    device_lm = None
    if args.device_lm:
        from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
        device_lm = DeviceCharLM.load(args.device_lm, tok,
                                      weight=args.device_lm_weight,
                                      max_order=args.device_lm_order)

    if args.manifest:
        items, ids = load_manifest_items(args.manifest, tok,
                                         cfg.data.audio.sample_rate,
                                         max_utts=args.max_utts)
    else:
        items, ids = load_dataset_items(args.data_dir, args.split, cfg.data.audio,
                                        max_utts=args.max_utts)
    if not items:
        raise SystemExit("no usable utterances to evaluate")

    result = evaluate_corpus(
        model, tok, cfg.data.audio, items, decoder=args.decoder,
        beam_width=args.beam_width, improved=args.improved,
        state_beam=args.state_beam, expand_beam=args.expand_beam, lm=lm,
        hotwords=args.hotwords, hotword_weight=args.hotword_weight,
        device_lm=device_lm, batch_size=args.batch_size,
        max_symbols=cfg.train.greedy_max_symbols,
        max_output_len=args.max_output_len, frame_bucket=args.frame_bucket,
        ids=ids, oracle_nbest=args.oracle_nbest, precision=args.precision)

    if args.dump:
        write_per_utt_jsonl(result, args.dump)
    summary = {"params": picked, "decoder": args.decoder, **result.summary()}
    print(json.dumps(summary, ensure_ascii=False), flush=True)
    return summary


if __name__ == "__main__":
    main()
