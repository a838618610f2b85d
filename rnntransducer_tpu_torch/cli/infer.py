"""Inference CLI of the port: the flags and checks of the JAX package's
``inference.py``, run on one CUDA device (``--device cpu`` asks for the
CPU).  A checkpoint is loaded, the waves go through the log-mel frontend
and one of the decoders, and each transcript is printed as
``<wav>\\t<text>``.

Examples:
  python -m rnntransducer_tpu_torch.cli.infer --checkpoint_dir ckpts --wav a.wav
  python -m rnntransducer_tpu_torch.cli.infer --checkpoint_dir ckpts --wav a.wav \\
      --decoder beam --beam_width 5 --lm_path lm.arpa --hotwords word
  python -m rnntransducer_tpu_torch.cli.infer --checkpoint_dir ckpts --wav a.wav \\
      --stream --chunk_ms 100

Decoders: ``beam`` (the default) is the host A/B search with improved
pruning, n-gram LM and hotword fusion; ``beam_batched`` the device beam
(with ``--device_lm``, an on-device char LM); ``greedy``.
"""

from __future__ import annotations

import argparse
from typing import List


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: best by val_cer, else latest)")
    p.add_argument("--average_k", type=int, default=None,
                   help="decode with the element-wise mean of the best K "
                        "retained checkpoints instead of a single step")
    p.add_argument("--use_ema", action="store_true",
                   help="decode with the EMA shadow params (requires "
                        "train.ema_decay > 0 at training time)")
    p.add_argument("--wav", type=str, nargs="+", required=True)
    p.add_argument("--vocab_path", type=str, default=None)
    # unset beam / LM flags fall back to the InferenceConfig persisted with
    # the checkpoint (cfg.inference)
    p.add_argument("--decoder", type=str, default="beam",
                   choices=["greedy", "beam", "beam_batched"])
    p.add_argument("--timestamps", action="store_true",
                   help="with --decoder greedy: print per-token emission "
                        "seconds after each transcript")
    p.add_argument("--beam_width", type=int, default=None)
    p.add_argument("--improved", action="store_true", default=None)
    p.add_argument("--no-improved", dest="improved", action="store_false")
    p.add_argument("--state_beam", type=float, default=None)
    p.add_argument("--expand_beam", type=float, default=None)
    p.add_argument("--lm_path", type=str, default=None,
                   help="ARPA n-gram LM for shallow fusion")
    p.add_argument("--lm_weight", type=float, default=None)
    p.add_argument("--hotwords", type=str, nargs="*", default=None)
    p.add_argument("--hotword_weight", type=float, default=None)
    p.add_argument("--device_lm", type=str, default=None,
                   help="char-level n-gram LM fused on the device inside the "
                        "beam's frame loop (decode/device_lm.py). Requires "
                        "--decoder beam_batched (or --stream with a beam "
                        "decoder); mutually exclusive with --lm_path/"
                        "--hotwords (host word-level fusion)")
    p.add_argument("--device_lm_weight", type=float, default=0.3)
    p.add_argument("--device_lm_order", type=int, default=3,
                   help="cap the dense char-LM table order (V^order entries)")
    p.add_argument("--nbest", type=int, default=1,
                   help="with a beam decoder (offline): print the top-N "
                        "hypotheses per wav (rank-tagged lines)")
    p.add_argument("--precision", choices=("fp32", "bf16"), default=None,
                   help="decode compute dtype (beam scores stay fp32); "
                        "default keeps the checkpoint's dtype")
    p.add_argument("--max_output_len", type=int, default=256)
    p.add_argument("--stream", action="store_true",
                   help="feed each wav in --chunk_ms chunks through the "
                        "incremental frontend and a carried encoder state, "
                        "printing partials (requires a unidirectional encoder)")
    p.add_argument("--chunk_ms", type=int, default=100)
    p.add_argument("--normalize", type=str, default=None,
                   choices=["none", "running", "fixed"],
                   help="streaming normalization (default: 'running' when "
                        "the model was trained with per-utterance norm)")
    p.add_argument("--norm_mean", type=float, default=0.0,
                   help="--normalize fixed calibration mean")
    p.add_argument("--norm_var", type=float, default=1.0,
                   help="--normalize fixed calibration variance")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a card)")
    return p.parse_args(argv)


def _check_flags(args) -> None:
    if args.decoder != "beam" and (args.lm_path or args.hotwords):
        raise SystemExit(
            f"--lm_path/--hotwords require --decoder beam "
            f"(the '{args.decoder}' decoder has no shallow fusion)")
    if args.timestamps and (args.decoder != "greedy" or args.stream):
        raise SystemExit("--timestamps requires --decoder greedy (offline; "
                         "streaming sessions expose .timestamps in the API)")
    if args.nbest > 1 and (args.decoder == "greedy" or args.stream):
        raise SystemExit("--nbest requires an offline beam decoder")
    if args.device_lm:
        if args.lm_path or args.hotwords:
            raise SystemExit(
                "--device_lm (on-device char fusion) and --lm_path/"
                "--hotwords (host word-level fusion) are mutually exclusive")
        if args.decoder == "greedy":
            raise SystemExit("--device_lm requires a beam decoder")
        if args.decoder == "beam" and not args.stream:
            raise SystemExit(
                "--device_lm fuses inside the device beam's frame loop — use "
                "--decoder beam_batched (offline) or --stream; --decoder "
                "beam is the host A/B search (use --lm_path there)")


def _merge_inference_config(args, inf) -> None:
    """Unset flags take the checkpoint's InferenceConfig; then the fusion
    check again, so a persisted lm_path / hotwords is caught too."""
    pick = lambda flag, cfg_val: cfg_val if flag is None else flag
    args.beam_width = pick(args.beam_width, inf.beam_width)
    args.improved = pick(args.improved, inf.improved)
    args.state_beam = pick(args.state_beam, inf.state_beam)
    args.expand_beam = pick(args.expand_beam, inf.expand_beam)
    args.lm_path = pick(args.lm_path, inf.lm_path)
    args.lm_weight = pick(args.lm_weight, inf.lm_weight)
    args.hotwords = pick(args.hotwords, list(inf.hotwords) or None)
    args.hotword_weight = pick(args.hotword_weight, inf.hotword_weight)
    if args.decoder != "beam" and (args.lm_path or args.hotwords):
        # fusion lives in the host A/B beam only: refusing beats silently
        # transcribing without the LM (pass --lm_path '' to override a
        # checkpoint-persisted LM path)
        raise SystemExit(
            f"--decoder {args.decoder} has no LM/hotword fusion (fusion "
            "runs in the host beam). Use --decoder beam, or drop the "
            "LM/hotword flags (pass --lm_path '' to override a "
            "checkpoint-persisted LM path).")


def main(argv=None) -> List[str]:
    """Run the CLI; returns the printed result lines (partials excluded)."""
    args = parse_args(argv)
    _check_flags(args)

    import numpy as np
    import torch

    from rnntransducer_tpu_torch.models.transducer import build_model
    from rnntransducer_tpu_torch.tokenizer import load_tokenizer
    from rnntransducer_tpu_torch.train.checkpoint import load_config, load_decode_params
    from rnntransducer_tpu_torch.utils.audio_io import read_wav
    from rnntransducer_tpu_torch.utils.device import resolve_device
    from rnntransducer_tpu_torch.utils.precision import decode_dtype

    cfg = load_config(args.checkpoint_dir)
    _merge_inference_config(args, cfg.inference)
    device = resolve_device(args.device)
    tok = load_tokenizer(args.vocab_path or cfg.vocab_path,
                         cfg.model.jointnet.num_classes)
    try:
        params, picked = load_decode_params(
            args.checkpoint_dir, cfg, step=args.step, average_k=args.average_k,
            use_ema=args.use_ema)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.average_k is not None:
        print(f"averaged checkpoints: {picked}")
    model = build_model(cfg, device, state_dict=params)
    if args.precision is not None:
        model.to(decode_dtype(args.precision))

    device_lm = None
    if args.device_lm:
        from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
        device_lm = DeviceCharLM.load(args.device_lm, tok, weight=args.device_lm_weight,
                                      max_order=args.device_lm_order).to(device)
    lm = None
    if args.lm_path:  # only --decoder beam is left with one after the checks
        from rnntransducer_tpu_torch.decode.ngram_lm import NGramLM
        lm = NGramLM.load(args.lm_path, weight=args.lm_weight)

    wavs = [read_wav(p, cfg.data.audio.sample_rate) for p in args.wav]
    blank = tok.blank_token_id
    max_symbols = cfg.train.greedy_max_symbols
    lines: List[str] = []

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    if args.stream:
        from rnntransducer_tpu_torch.decode.streaming import StreamingRecognizer
        norm = args.normalize or ("running" if cfg.data.audio.normalize else "none")
        chunk = max(1, cfg.data.audio.sample_rate * args.chunk_ms // 1000)
        use_beam = args.decoder in ("beam", "beam_batched")
        for path, wav in zip(args.wav, wavs):
            rec = StreamingRecognizer(
                model, cfg.data.audio, blank_id=blank, max_symbols=max_symbols,
                max_output_len=args.max_output_len, normalize=norm,
                decoder="beam" if use_beam else "greedy",
                beam_width=args.beam_width, norm_mean=args.norm_mean,
                norm_var=args.norm_var, lm=lm, hotwords=args.hotwords,
                hotword_weight=args.hotword_weight, tokenizer=tok,
                improved=args.improved, state_beam=args.state_beam,
                expand_beam=args.expand_beam, device_lm=device_lm)
            emitted = []  # greedy: feed()'s returns; a .tokens poll refetches
            for s in range(0, len(wav), chunk):
                emitted += rec.feed(wav[s:s + chunk])
                partial = tok.decode(rec.tokens if use_beam else emitted,
                                     group_tokens=False)
                print(f"\r{path}\t{partial}", end="", flush=True)
            rec.flush()
            print("\r", end="")
            emit(f"{path}\t{tok.decode(rec.tokens, group_tokens=False)}")
        return lines

    from rnntransducer_tpu_torch.frontend.melspec import LogMelFrontend
    S = max(len(w) for w in wavs)
    batch = np.zeros((len(wavs), S), np.float32)
    lengths = np.zeros((len(wavs),), np.int32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
        lengths[i] = len(w)
    feats, feat_lengths = LogMelFrontend(cfg.data.audio)(
        torch.from_numpy(batch).to(device), torch.from_numpy(lengths).to(device))

    times = None
    nbest_lists = None
    with torch.inference_mode():
        if args.decoder == "greedy":
            from rnntransducer_tpu_torch.decode.greedy import greedy_decode_with_times
            toks, lens, frames = greedy_decode_with_times(
                model, feats, feat_lengths, blank_id=blank, max_symbols=max_symbols,
                max_output_len=args.max_output_len)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            hyps = [list(toks[i, :lens[i]]) for i in range(len(wavs))]
            if args.timestamps:
                sec = (cfg.model.transnet.time_reduction_stride
                       * cfg.data.audio.window_stride_sec)
                frames = frames.cpu().numpy()
                times = [[round(float(f) * sec, 3) for f in frames[i, :lens[i]]]
                         for i in range(len(wavs))]
        elif args.decoder == "beam_batched":
            from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
            toks, lens, _ = batched_beam_decode(
                model, feats, feat_lengths, blank_id=blank,
                beam_width=args.beam_width, max_symbols=max_symbols,
                max_output_len=args.max_output_len, device_lm=device_lm)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            hyps = [list(toks[i, 0, :lens[i, 0]]) for i in range(len(wavs))]
            K = min(args.nbest, toks.shape[1])
            nbest_lists = [[list(toks[i, k, :lens[i, k]]) for k in range(K)]
                           for i in range(len(wavs))]
        else:
            from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
            decoder = BeamSearchDecoder(
                model, blank_id=blank, tokenizer=tok, beam_width=args.beam_width,
                improved=args.improved, state_beam=args.state_beam,
                expand_beam=args.expand_beam, lm=lm, hotwords=args.hotwords,
                hotword_weight=args.hotword_weight)
            hyps, nbest_lists = [], []
            for i in range(len(wavs)):
                nbest = decoder.decode(feats[i:i + 1], feat_lengths[i:i + 1])
                hyps.append(nbest[0])
                nbest_lists.append(nbest[:args.nbest])

    for i, (path, hyp) in enumerate(zip(args.wav, hyps)):
        emit(f"{path}\t{tok.decode(hyp, group_tokens=False)}")
        if args.nbest > 1:
            for k, y in enumerate(nbest_lists[i]):
                emit(f"{path}\tnbest[{k}]\t{tok.decode(y, group_tokens=False)}")
        if times is not None:
            stamps = " ".join(f"{tok.decode([t], group_tokens=False)}@{s}"
                              for t, s in zip(hyp, times[i]))
            emit(f"{path}\ttimes\t{stamps}")
    return lines


if __name__ == "__main__":
    main()
