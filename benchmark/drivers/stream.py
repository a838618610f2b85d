"""Real-time streaming: an open loop of S concurrent streams through
``decode/session_batch.BatchedStreamingRunner`` (one lane a stream), as
``serve_socket.StreamingServer``'s batched mode drives it.

Every stream feeds one chunk of audio (the traffic's ``feed_samples``, 640
ms) on its own schedule, whether or not its earlier chunks have come back;
the streams' phases are spread evenly over one chunk period.  A stream plays
sessions back to back: a session whose audio has ended is flushed and a new
one opens in its place at once.  One host thread plays the schedule: it
feeds every stream that is due (``feed(drain=False)``), flushes the
sessions that ended, and otherwise calls ``runner.drain()`` once, so every
lane with a full chunk rides in the same tick.

A chunk is the runner's: ``chunk_frames`` feature frames.  Its latency runs
from when the feed that completed its audio was due to when the call that
ran its tick returned; a stall delays every later chunk.  The schedule
starts ``warm_s`` before the window, so the window opens in steady state;
the chunks due inside the window are the ones counted.

After the window every pending chunk is drained; then a sample of the
sessions that finished in the window, drawn from the seed with the longest
among them, is walked through the plain reference (``reference/walk.py``):
the widest gap by which a served decision lies below the reference's best.
"""

from __future__ import annotations

import gc
import heapq
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from benchmark.harness.common import Outcome, Spans, log, process_age_s
from benchmark.harness.trace import profiled, summarize
from benchmark.harness.traffic import utterances


@dataclass
class _Session:
    sess: object
    utt: int                      # index into the utterances
    fed: int = 0                  # samples fed
    chunks_done: int = 0          # chunks whose partials came back
    chunk_due: List[float] = field(default_factory=list)
    tokens0: int = 0


def _frames(samples: int, n_fft: int, hop: int) -> int:
    """Feature frames the streaming frontend has produced after
    ``samples`` (windows that need no right-side padding)."""
    return max(0, (samples - n_fft + n_fft // 2) // hop + 1)


class Player:
    """The open-loop schedule over S lanes."""

    def __init__(self, runner, utts, mix: dict, audio, streams: int, seed: int):
        self.runner, self.utts, self.mix = runner, utts, mix
        self.feed = int(mix["feed_samples"])
        self.period = self.feed / utts.sample_rate
        self.n_fft, self.hop = audio.n_fft, audio.hop_length
        self.chunk = runner.chunk_frames
        self.streams = streams
        # the same session lengths in the same order for every seed: the
        # utterances sorted by length, permuted by the traffic's order seed
        by_length = np.argsort(utts.samples, kind="stable")
        perm = np.random.RandomState(mix.get("order_seed", 0)).permutation(len(utts))
        self.order = by_length[perm]
        self.next_utt = 0
        self.lanes: List[Optional[_Session]] = [None] * streams
        self.heap: list = []
        self.latencies: List[tuple] = []   # (due, latency)
        self.finished: List[dict] = []
        self.drains: List[tuple] = []      # (ticks, seconds, due)
        self.window = (float("inf"), float("inf"))
        self.frames_in_window = 0
        self.lateness: List[float] = []

    def _open(self, lane: int) -> None:
        u = int(self.order[self.next_utt % len(self.order)])
        self.next_utt += 1
        self.lanes[lane] = _Session(self.runner.open(normalize="none"), u)

    def start(self, t0: float) -> None:
        for lane in range(self.streams):
            self._open(lane)
            heapq.heappush(self.heap, (t0 + (lane + 0.5) / self.streams * self.period, lane))

    def _feed(self, lane: int, due: float) -> bool:
        """Feed the lane's next piece; True where its session's audio ended."""
        s = self.lanes[lane]
        wav = self.utts.wav(s.utt)
        piece = wav[s.fed:s.fed + self.feed]
        s.sess.feed(piece, drain=False)
        s.fed += len(piece)
        done = _frames(s.fed, self.n_fft, self.hop) // self.chunk
        s.chunk_due += [due] * (done - len(s.chunk_due))
        return s.fed >= len(wav)

    def _in_window(self, due: float) -> bool:
        return self.window[0] <= due < self.window[1]

    def _returned(self, now: float, lanes) -> None:
        for lane in lanes:
            s = self.lanes[lane]
            for due in s.chunk_due[s.chunks_done:]:
                self.latencies.append((due, now - due))
                if self._in_window(due):
                    self.frames_in_window += self.chunk
            s.chunks_done = len(s.chunk_due)

    def step(self, clock, spans: Spans) -> bool:
        """Serve whatever is due now, or wait for it.  False once the heap
        holds nothing due before the window's end."""
        now = clock()
        if not self.heap or self.heap[0][0] >= self.window[1]:
            return False
        if self.heap[0][0] > now:
            time.sleep(min(self.heap[0][0] - now, 0.002))
            return True
        due_lanes, ended = [], []
        while self.heap and self.heap[0][0] <= now:
            due, lane = heapq.heappop(self.heap)
            self.lateness.append(now - due)
            with spans.span("feed"):
                if self._feed(lane, due):
                    ended.append((lane, due))
            due_lanes.append((lane, due))
        for lane, due in ended:
            s = self.lanes[lane]
            with spans.span("flush"):
                tokens = s.sess.flush()
            t = clock()
            self._returned(t, range(self.streams))
            tail = len(self.utts.wav(s.utt)) // self.hop + 1 - self.chunk * len(s.chunk_due)
            if tail > 0:                       # the flushed partial chunk
                self.latencies.append((due, t - due))
                if self._in_window(due):
                    self.frames_in_window += tail
            times = s.sess.timestamps
            if self._in_window(t):
                self.finished.append({"utt": s.utt, "tokens": list(tokens),
                                      "frames": [int(round(x / self.runner.frame_sec))
                                                 for x in times]})
        if not ended:
            with spans.span("drain"):
                t = clock()
                ticks = self.runner.drain()
                t1 = clock()
            self.drains.append((ticks, t1 - t, t))
            self._returned(t1, range(self.streams))
        for lane, due in due_lanes:
            if any(lane == e for e, _ in ended):
                self._open(lane)
            heapq.heappush(self.heap, (due + self.period, lane))
        return True

    def finish(self, clock) -> None:
        """Stop feeding; drain what is pending."""
        self.runner.drain()
        self._returned(clock(), range(self.streams))


def _model(cell, seed: int, device):
    import torch
    from rnntransducer_tpu_torch.config import Config
    from rnntransducer_tpu_torch.models.transducer import build_model
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
    model = build_model(cfg, device, state_dict=params)
    model.to(torch.bfloat16 if cell.traffic.get("precision", "bf16") == "bf16"
             else torch.float32)
    return cfg, model, params


def _play(cell, cfg, model, streams: int, seed: int, seconds: float, trace: bool,
          fault: str = ""):
    import torch
    from rnntransducer_tpu_torch.decode.session_batch import BatchedStreamingRunner
    mix = cell.traffic
    device = torch.device(cell.device)
    utts = utterances(mix, mix["utterances"]["count"], seed)
    runner = BatchedStreamingRunner(
        model, cfg.data.audio, max_sessions=streams, chunk_frames=mix["chunk_frames"],
        blank_id=cfg.data.text.pad_token_id, max_symbols=cfg.train.greedy_max_symbols,
        max_output_len=mix["max_output_len"], decoder="greedy")
    if fault == "token":
        _plant_token_fault(runner)
    runner.warmup()
    spans = Spans(tracing=trace)
    player = Player(runner, utts, mix, cfg.data.audio, streams, seed)
    clock = time.perf_counter
    t_start = clock()
    player.start(t_start)
    warm_end = t_start + mix["warm_s"]
    player.window = (warm_end, float("inf"))
    while clock() < warm_end:
        player.step(clock, Spans())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = process_age_s()
    tokens0 = {id(s): len(s.sess.tokens) for s in player.lanes}
    drains0 = len(player.drains)
    with profiled(trace) as prof:
        t0 = clock()
        player.window = (t0, t0 + seconds)
        while player.step(clock, spans):
            pass
        with spans.span("drain"):
            player.finish(clock)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        window_s = clock() - t0
    summary = summarize(prof, window_s) if prof is not None else None
    lat = [l for due, l in player.latencies if t0 <= due < t0 + seconds]
    tokens = sum(len(f["tokens"]) for f in player.finished)
    tokens += sum(len(s.sess.tokens) - tokens0.get(id(s), 0) for s in player.lanes)
    drains = player.drains[drains0:]
    return {"runner": runner, "player": player, "lat": lat, "window_s": window_s,
            "summary": summary, "spans": spans, "tokens": tokens, "drains": drains,
            "utts": utts, "setup_s": setup_s, "t0": t0}


def _plant_token_fault(runner) -> None:
    """A served token altered where it is produced: every fetched partial's
    first token moved to the next id (tests)."""
    fetch = runner._fetch

    def altered(carry):
        toks, n, times = fetch(carry)
        toks = toks.copy()
        toks[:, 0] = np.where(n > 0, (toks[:, 0] % 50) + 5, toks[:, 0])
        return toks, n, times
    runner._fetch = altered


def _sample(finished: List[dict], seed: int, want_tokens: int, max_len: int) -> List[dict]:
    ok = [f for f in finished if f["tokens"]]
    if not ok:
        return finished[:1]
    rng = np.random.RandomState((seed + 17) % 2 ** 32)
    longest = max(ok, key=lambda f: len(f["tokens"]))
    out, total = [longest], len(longest["tokens"])
    for i in rng.permutation(len(ok)):
        if total >= want_tokens:
            break
        if ok[i] is not longest:
            out.append(ok[i])
            total += len(ok[i]["tokens"])
    return out


def _readings(cell, params, sample, utts, device, control: bool = False) -> dict:
    """Walk every sampled session through the fp32 reference; with
    ``control``, also read the fp8 reference's first choices on each path."""
    import torch
    from benchmark.reference.frontend import logmel
    from benchmark.reference.model import Reference
    from benchmark.reference.precision import exact_float32
    from benchmark.reference.walk import control_gaps, walk
    run = cell.run_cfg
    cap = float(cell.limits.get("walk_cap", 1.0))
    max_sym = run["train"].get("greedy_max_symbols", 3)
    P = {k: v.float() for k, v in params.items()}
    ref = Reference(run["model"], P, "fp32")
    ref8 = Reference(run["model"], P, "fp8")
    out = {"gap": 0.0, "tokens": 0, "sessions": len(sample), "control": 0.0}
    with exact_float32(), torch.no_grad():
        waves = [torch.from_numpy(utts.wav(f["utt"]).copy()) for f in sample]
        feats, n = logmel(waves, run["data"]["audio"], device)
        enc, elen = ref.encode(feats, n)
        A = ref.enc_factor(enc).double().cpu().numpy()
        if control:
            enc8, _ = ref8.encode(feats, n)
            A8 = ref8.enc_factor(enc8).double().cpu().numpy()
        for i, f in enumerate(sample):
            T = int(elen[i])
            gap, path = walk(ref, A[i, :T], f["tokens"], f["frames"], max_sym, cap, device,
                             full=len(f["tokens"]) >= cell.traffic["max_output_len"])
            log(f"session {f['utt']}: {len(f['tokens'])} tokens over {T} frames, "
                f"widest gap {gap:.6g}")
            out["gap"] = max(out["gap"], gap)
            out["tokens"] += len(f["tokens"])
            if control and path is not None:
                out["control"] = max(out["control"], control_gaps(
                    ref, ref8, A[i, :T], A8[i, :T], path, device))
    return out


def run(cell) -> Outcome:
    import torch
    device = torch.device(cell.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mix = cell.traffic
    cfg, model, params = _model(cell, cell.seed, device)
    seconds = cell.seconds
    r = _play(cell, cfg, model, mix["streams"], cell.seed, seconds, cell.trace,
              cell.options.get("fault", ""))
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    sample = _sample(r["player"].finished, cell.seed, mix["check_tokens"],
                     mix["max_output_len"])
    log(f"window: {len(r['lat'])} chunks in {r['window_s']:.3f} s, "
        f"{len(r['player'].finished)} sessions finished, {len(sample)} sampled")
    del r["runner"], model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = _readings(cell, params, sample, r["utts"], device) if sample else {"gap": float("inf")}
    checks = [("served_gap", got["gap"], float(cell.limits["checks"]["served_gap"]))]
    lat = r["lat"]
    p95 = float(np.percentile(lat, 95)) * 1e3 if lat else float("inf")
    ctx = {"kind": "stream", "spans": r["spans"].times, "trace": r["summary"],
           "window_s": r["window_s"], "drains": r["drains"], "tokens": r["tokens"],
           "frames": r["player"].frames_in_window, "model": cell.run_cfg["model"],
           "precision": mix.get("precision", "bf16"), "streams": mix["streams"],
           "chunk_frames": mix["chunk_frames"], "readings": got}
    return Outcome({"stream_chunk_p95_ms": p95}, len(lat), 0, checks, ctx, peak,
                   r["setup_s"])


def calibrate(cell, seeds, control_seeds, fault_seeds, out) -> None:
    """With ``cell.options['sweep']`` (stream counts): the knee sweep, one
    line per count: chunk p50 / p95 / p99, the schedule's lateness, the
    ticks.  Otherwise the readings the served-gap limit is set from: the
    program's over ``seeds`` and the fp8 control's over ``control_seeds``."""
    import torch
    device = torch.device(cell.device)
    mix = cell.traffic
    sweep = cell.options.get("sweep")
    for seed in seeds:
        cfg, model, params = _model(cell, seed, device)
        for streams in (sweep or [mix["streams"]]):
            t = time.perf_counter()
            r = _play(cell, cfg, model, streams, seed, cell.seconds, False)
            lat = np.array(r["lat"]) * 1e3
            late = np.array(r["player"].lateness) * 1e3
            one = [s for k, s, _ in r["drains"] if k == 1]
            line = {"seed": seed, "streams": streams, "chunks": len(lat),
                    "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "late_p95_ms": float(np.percentile(late, 95)),
                    "first_half_p95": float(np.percentile(lat[:len(lat) // 2], 95)),
                    "second_half_p95": float(np.percentile(lat[len(lat) // 2:], 95)),
                    "tick_p50_ms": 1e3 * float(np.median(one)) if one else None,
                    "drains": len(r["drains"]), "finished": len(r["player"].finished)}
            if not sweep:
                sample = _sample(r["player"].finished, seed, mix["check_tokens"],
                                 mix["max_output_len"])
                line["readings"] = _readings(cell, params, sample, r["utts"], device,
                                             control=seed in control_seeds)
            line["seconds"] = time.perf_counter() - t
            print(json.dumps(line), file=out, flush=True)
            del r
            gc.collect()
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
