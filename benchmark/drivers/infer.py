"""Offline transcription: ``serve.Recognizer.transcribe_batch`` with the
greedy decoder, in bf16, on raw PCM, as ``cli/infer`` and evaluation call
it.  One client in a closed loop: batches of the traffic's ``batch``
utterances, formed from the length-sorted utterances and sent in an order
drawn from the traffic's order seed, so every run seed sends the same
lengths in the same order on other audio; the next batch goes when the
last one's text is back.

The harness reads the token ids each request served where the Recognizer
hands them to its text decoding.  After the window, a sample of the
transcribed utterances drawn from the seed, with the longest among them, is
walked through the plain reference (``reference/walk.py``, without
emission times): the widest gap by which a served decision lies below the
reference's best.
"""

from __future__ import annotations

import gc
import json
import time
from typing import List

import numpy as np

from benchmark.harness.common import Outcome, Spans, log, process_age_s
from benchmark.harness.trace import profiled, summarize
from benchmark.harness.traffic import utterances


def _recognizer(cell, seed: int, device):
    import torch
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.serve import Recognizer
    from rnntransducer_tpu_torch.tokenizer import load_tokenizer
    from benchmark.reference.model import param_specs, seeded_params
    run = cell.run_cfg
    cfg = Config.from_dict(run)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = cell.config.get("weights", {})
    params = seeded_params(param_specs(run["model"]), gen, device,
                           blank_bias=w.get("blank_bias", 0.0),
                           suppressed=w.get("suppressed"),
                           suppress_bias=w.get("suppress_bias", 0.0),
                           encoder_gain=w.get("encoder_gain", 1.0),
                           joint_scale=w.get("joint_scale", 1.0))
    rec = Recognizer(cfg, params, load_tokenizer(None, cfg.model.jointnet.num_classes),
                     decoder="greedy", max_output_len=cell.traffic["max_output_len"],
                     compose_hangul=False, precision=cell.traffic.get("precision", "bf16"),
                     device=device)
    return cfg, rec, params


def _tap(rec, served: List[list], times: List[list]) -> None:
    """Record the token ids of every utterance the Recognizer decodes to
    text, in order, and, where its decode is the greedy frame loop, each
    token's emission frame: ``serve.greedy_decode`` is called as the frame
    loop with its times kept (the same device work; the times stay on the
    card until the window has closed)."""
    import rnntransducer_tpu_torch.serve as serve
    from rnntransducer_tpu_torch.decode.greedy import greedy_decode
    decode_text = rec._decode_text
    greedy = serve.greedy_decode

    def recording(ids):
        served.append([int(i) for i in ids])
        return decode_text(ids)

    def timed(*a, **k):
        if greedy is not greedy_decode:
            return greedy(*a, **k)
        toks, lens, t = serve.greedy_decode_with_times(*a, **k)
        times.append((t, lens))
        return toks, lens
    rec._decode_text = recording
    serve.greedy_decode = timed
    rec._restore = (serve, greedy)


def _plant_token_fault(rec) -> None:
    """A served token altered where it is produced (tests): the first token
    of every utterance moved to another id before the text is made."""
    decode_text = rec._decode_text

    def altered(ids):
        ids = [int(i) for i in ids]
        if ids:
            ids[0] = 5 + (ids[0] - 4) % 50
        return decode_text(ids)
    rec._decode_text = altered


def _batches(utts, size: int, order_seed: int) -> List[np.ndarray]:
    """Batches of ``size`` consecutive utterances in length order, sent in
    an order drawn from the traffic's order seed: every run seed sends the
    same lengths in the same order, other audio."""
    order = np.argsort(utts.samples, kind="stable")
    groups = [order[i:i + size] for i in range(0, len(order), size)]
    perm = np.random.RandomState(order_seed).permutation(len(groups))
    return [groups[i] for i in perm]


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _play(cell, rec, utts, seconds: float, trace: bool, fault: str = ""):
    device = rec.device
    mix = cell.traffic
    batches = _batches(utts, mix["batch"], mix.get("order_seed", 0))
    served: List[list] = []
    times: List[tuple] = []
    _tap(rec, served, times)
    if fault == "token":
        _plant_token_fault(rec)
    hop = rec.cfg.data.audio.hop_length
    # warm-up: the longest and the shortest batch
    for idxs in (max(batches, key=lambda b: utts.samples[b].max()),
                 min(batches, key=lambda b: utts.samples[b].max())):
        rec.transcribe_batch([utts.wav(i) for i in idxs])
    _sync(device)
    setup_s = process_age_s()
    served.clear()
    times.clear()
    spans = Spans(tracing=trace)
    done, audio_s = [], 0.0
    with profiled(trace) as prof:
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            idxs = batches[k % len(batches)]
            k += 1
            with spans.span("transcribe_batch"):
                rec.transcribe_batch([utts.wav(i) for i in idxs])
            frames = [int(utts.samples[i]) // hop + 1 for i in idxs]
            done.append({"idxs": idxs, "frames": frames, "T": max(frames)})
            audio_s += float(utts.samples[idxs].sum()) / utts.sample_rate
        window_s = time.perf_counter() - t0
    summary = summarize(prof, window_s) if prof is not None else None
    frames = [[int(x) for x in t[r, :int(n[r])].tolist()]
              for t, n in times for r in range(t.shape[0])]
    return done, served, frames, audio_s, window_s, spans, summary, setup_s


def _sample(done, served, frames, seed: int, want_tokens: int, max_len: int):
    """(utterance, tokens, frames or None) of a sample drawn from the seed,
    the longest transcript among them."""
    order = [int(i) for d in done for i in d["idxs"]]
    if len(frames) != len(served):
        frames = [None] * len(served)
    rows = list(zip(order, served, frames))
    ok = [r for r in rows if r[1] and (r[2] is not None or len(r[1]) < max_len)]
    if not ok:
        return rows[:1]
    longest = max(ok, key=lambda r: len(r[1]))
    rng = np.random.RandomState((seed + 23) % 2 ** 32)
    out, total = [longest], len(longest[1])
    for j in rng.permutation(len(ok)):
        if total >= want_tokens:
            break
        if ok[j][0] != longest[0]:
            out.append(ok[j])
            total += len(ok[j][1])
    return out


def _readings(cell, params, sample, utts, device, control: bool = False) -> dict:
    import torch
    from benchmark.reference.frontend import logmel
    from benchmark.reference.model import Reference
    from benchmark.reference.precision import exact_float32
    from benchmark.reference.walk import control_gaps, walk
    run = cell.run_cfg
    cap = float(cell.limits.get("walk_cap", 1.0))
    max_sym = run["train"].get("greedy_max_symbols", 3)
    P = {k: v.float() for k, v in params.items()}
    ref, ref8 = Reference(run["model"], P, "fp32"), Reference(run["model"], P, "fp8")
    out = {"gap": 0.0, "tokens": 0, "utterances": len(sample), "control": 0.0}
    with exact_float32(), torch.no_grad():
        waves = [torch.from_numpy(utts.wav(i).copy()) for i, _, _ in sample]
        feats, n = logmel(waves, run["data"]["audio"], device)
        enc, elen = ref.encode(feats, n)
        A = ref.enc_factor(enc).double().cpu().numpy()
        if control:
            A8 = ref8.enc_factor(ref8.encode(feats, n)[0]).double().cpu().numpy()
        for r, (i, toks, frames) in enumerate(sample):
            T = int(elen[r])
            gap, path = walk(ref, A[r, :T], toks, frames, max_sym, cap, device,
                             full=len(toks) >= cell.traffic["max_output_len"])
            log(f"utterance {i}: {len(toks)} tokens over {T} frames "
                f"({'with' if frames else 'without'} times), widest gap {gap:.6g}")
            out["gap"] = max(out["gap"], gap)
            out["tokens"] += len(toks)
            if control and path is not None:
                out["control"] = max(out["control"], control_gaps(
                    ref, ref8, A[r, :T], A8[r, :T], path, device))
    return out


def run(cell) -> Outcome:
    import torch
    device = torch.device(cell.device)
    mix = cell.traffic
    if device.type == "cuda":
        from rnntransducer_tpu_torch.ops import build
        build.build_all(["gru_fwd", "lstm_fwd"])
        torch.cuda.reset_peak_memory_stats(device)
    cfg, rec, params = _recognizer(cell, cell.seed, device)
    utts = utterances(mix, mix["utterances"]["count"], cell.seed)
    seconds = cell.seconds
    try:
        done, served, frames, audio_s, window_s, spans, summary, setup_s = _play(
            cell, rec, utts, seconds, cell.trace, cell.options.get("fault", ""))
    finally:
        restore = getattr(rec, "_restore", None)
        if restore:
            setattr(restore[0], "greedy_decode", restore[1])
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    log(f"window: {len(done)} batches, {audio_s:.1f} s of audio in {window_s:.3f} s")
    tokens = sum(len(t) for t in served)
    del rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = _sample(done, served, frames, cell.seed, mix["check_tokens"],
                     mix["max_output_len"])
    got = _readings(cell, params, sample, utts, device) if sample else {"gap": float("inf")}
    log(f"reference: {got}")
    checks = [("served_gap", got["gap"], float(cell.limits["checks"]["served_gap"]))]
    steps = [{"T": d["T"], "frames": d["frames"]} for d in done]
    ctx = {"kind": "infer", "spans": spans.times, "trace": summary, "window_s": window_s,
           "steps": steps, "frames": sum(sum(d["frames"]) for d in done), "tokens": tokens,
           "model": cell.run_cfg["model"], "precision": mix.get("precision", "bf16"),
           "readings": got}
    return Outcome({"infer_audio_s_per_s": audio_s / window_s},
                   sum(len(d["idxs"]) for d in done), 0, checks, ctx, peak, setup_s)


def calibrate(cell, seeds, control_seeds, fault_seeds, out) -> None:
    """The readings the served-gap limit is set from: the program's over
    ``seeds``, the fp8 control's over ``control_seeds``."""
    import torch
    device = torch.device(cell.device)
    if device.type == "cuda":
        from rnntransducer_tpu_torch.ops import build
        build.build_all(["gru_fwd", "lstm_fwd"])
    mix = cell.traffic
    for seed in seeds:
        t = time.perf_counter()
        cell.seed = seed
        cfg, rec, params = _recognizer(cell, seed, device)
        utts = utterances(mix, mix["utterances"]["count"], seed)
        done, served, frames, audio_s, window_s, *_ = _play(cell, rec, utts, cell.seconds,
                                                            False)
        restore = getattr(rec, "_restore", None)
        if restore:
            setattr(restore[0], "greedy_decode", restore[1])
        del rec
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
        sample = _sample(done, served, frames, seed, mix["check_tokens"],
                         mix["max_output_len"])
        line = {"seed": seed, "audio_s_per_s": audio_s / window_s, "batches": len(done),
                "readings": _readings(cell, params, sample, utts, device,
                                      control=seed in control_seeds),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), file=out, flush=True)
