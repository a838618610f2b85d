"""Streaming recognition over TCP (port of
``rnntransducer_tpu/serve_socket.py``): the network serving layer over the
``Recognizer`` / ``StreamingRecognizer`` session API.

Protocol (one session per TCP connection, little-endian):

    client -> server:  [int32 n][n bytes]   raw PCM chunk: int16 samples at
                                            the model sample rate
                       [int32 0]            end of stream
    server -> client:  newline-delimited JSON after every chunk:
                       {"partial": "<best text so far>"}
                       and at the end of the stream:
                       {"final": "<text>", "tokens": [...]}\\n
                       (greedy sessions add "times", per-token seconds)

Concurrency: sessions run on threads of their own.  Per-connection sessions
(``batch_sessions=0``) each own their streaming state and take turns on
the device under one process-wide lock.  With ``batch_sessions > 0`` the
connections share a ``decode.session_batch.BatchedStreamingRunner``: one
tick serves every lane, and the runner's own tick / state locks order the
work, so a connection keeps buffering and polling while a tick runs.  With
a ``mesh`` (``--shard_sessions``) the lanes shard over several devices.

    server = StreamingServer(recognizer, port=0)        # 0 = ephemeral
    server.start()                                      # background thread
    ... server.port ...
    server.stop()

CLI, on the card unless ``--device cpu``:
``python -m rnntransducer_tpu_torch.serve_socket --checkpoint_dir ckpts
--port 7070 [--decoder greedy|beam] [--batch_sessions 64
[--shard_sessions]]``.  SIGTERM or
SIGINT drains the sessions in flight, then the process exits 0.
"""

from __future__ import annotations

import contextlib
import json
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def _send(conn: socket.socket, msg: dict) -> None:
    conn.sendall((json.dumps(msg) + "\n").encode())


class StreamingServer:
    def __init__(self, recognizer, host: str = "127.0.0.1", port: int = 0,
                 chunk_frames: Optional[int] = None, batch_sessions: int = 0,
                 mesh=None, warmup: bool = True, **session_kw):
        """batch_sessions > 0 turns on continuous batching: up to that many
        concurrent connections share one device tick
        (``decode/session_batch``) instead of a batch-1 encoder call per
        session; it follows the recognizer's decoder (greedy or beam) and
        its fusion (host LM / hotwords, or the device char LM).
        ``mesh``: a list of devices (``parallel.mesh.lane_devices``) the
        batched lanes shard over, a lane group each; ignored without
        ``batch_sessions``, as in the JAX server.
        ``warmup``: build the kernels and run the batched tick / reset /
        fetch (or a throwaway session) in ``start()``, before the socket
        binds, so no client waits for them."""
        self.recognizer = recognizer
        self.host = host
        self._requested_port = port
        self.chunk_frames = chunk_frames
        self.session_kw = session_kw
        self._device_lock = threading.Lock()
        # connection counters: let tests and health checks wait for an
        # abnormal client's handler to finish (a handler can lag its
        # client's disconnect, briefly holding a batched slot)
        self._conns_done = 0
        self._conns_started = 0
        self._count_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.port: Optional[int] = None
        self._runner = None
        self._warmup = warmup
        if batch_sessions > 0:
            from rnntransducer_tpu_torch.decode.session_batch import (
                BatchedStreamingRunner)
            rec = recognizer
            inf = rec.cfg.inference
            fused_kw = {}
            if rec.fused:
                # batched sessions + LM / hotword fusion: every lane runs the
                # host A/B search, wave scoring batched across lanes
                fused_kw = dict(lm=rec.lm, hotwords=rec.hotwords,
                                hotword_weight=rec.hotword_weight,
                                tokenizer=rec.tokenizer, improved=inf.improved,
                                state_beam=inf.state_beam,
                                expand_beam=inf.expand_beam)
            self._runner = BatchedStreamingRunner(
                rec.model, rec.cfg.data.audio, max_sessions=batch_sessions,
                chunk_frames=chunk_frames or inf.streaming_chunk_frames,
                blank_id=rec.tokenizer.blank_token_id,
                max_symbols=rec.cfg.train.greedy_max_symbols,
                max_output_len=rec.max_output_len,
                decoder="beam" if rec.decoder != "greedy" else "greedy",
                beam_width=rec.beam_width, mesh=mesh, device_lm=rec.device_lm,
                **fused_kw)

    # ------------------------------------------------------------- session
    def _open(self):
        if self._runner is None:
            return self.recognizer.stream(chunk_frames=self.chunk_frames,
                                          **self.session_kw)
        kw = {k: v for k, v in self.session_kw.items()
              if k in ("normalize", "norm_mean", "norm_var")}
        kw.setdefault("normalize", "running"
                      if self.recognizer.cfg.data.audio.normalize else "none")
        return self._runner.open(**kw)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            try:
                sess = self._open()
            except Exception as e:  # e.g. a bidirectional encoder, slots full
                _send(conn, {"error": str(e)})
                return
            # batched sessions order their device work through the runner's
            # tick / state locks; the process-wide lock would serialize every
            # lane, so only per-connection sessions take it
            lock = (contextlib.nullcontext() if self._runner is not None
                    else self._device_lock)
            beam = sess.decoder == "beam"
            emitted: list = []  # greedy partials accumulate from feed()'s
            # returns; a .tokens poll would fetch the whole buffer per chunk
            try:
                while True:
                    hdr = _recv_exact(conn, 4)
                    if hdr is None:
                        return  # client vanished mid-stream: no final
                    (n,) = struct.unpack("<i", hdr)
                    if n <= 0:
                        break  # end of stream
                    payload = _recv_exact(conn, n)
                    if payload is None:
                        return
                    if n % 2:
                        _send(conn, {"error": f"odd payload length {n}: "
                                              "samples are int16"})
                        return
                    pcm = np.frombuffer(payload, dtype="<i2").astype(np.float32)
                    pcm /= 32768.0
                    with lock:
                        emitted += sess.feed(pcm)
                        toks = sess.tokens if beam else emitted
                        partial = self.recognizer._decode_text(toks)
                    _send(conn, {"partial": partial})
                with lock:
                    fin = sess.flush()
                    # flush() frees a batched session's slot, so .tokens is
                    # never read after it (another connection's open() may
                    # reuse the slot).  Beam: flush() returns the final ranked
                    # best; greedy: the trailing emission.
                    if beam:
                        tokens = list(fin)
                    else:
                        emitted += fin
                        tokens = list(emitted)
                    final = self.recognizer._decode_text(tokens)
                msg = {"final": final, "tokens": [int(t) for t in tokens]}
                if not beam:  # greedy: per-token emission seconds
                    msg["times"] = [round(t, 3) for t in sess.timestamps]
                _send(conn, msg)
            finally:
                # abnormal exits (disconnect, protocol error, a feed that
                # raised) must still free a batched session's slot; a no-op
                # after a clean flush()
                abort = getattr(sess, "abort", None)
                if abort is not None:
                    abort()
        except (ConnectionError, BrokenPipeError):
            pass
        except Exception as e:
            # never leave the client hanging on an unanswered readline
            try:
                _send(conn, {"error": str(e)})
            except OSError:
                pass
        finally:
            conn.close()
            with self._count_lock:
                self._conns_done += 1

    # -------------------------------------------------------------- server
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            with self._count_lock:
                self._conns_started += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def start(self) -> "StreamingServer":
        # warm before binding: a client never finds the server reachable
        # while its first chunk would wait for kernel builds
        if self._warmup and self._runner is not None:
            self._runner.warmup()
        elif self._warmup:
            # a throwaway session fed a little more than one chunk of silence
            rec = self.recognizer
            sess = rec.stream(chunk_frames=self.chunk_frames, **self.session_kw)
            acfg = rec.cfg.data.audio
            cf = self.chunk_frames or rec.cfg.inference.streaming_chunk_frames
            sess.feed(np.zeros((cf + 2) * acfg.hop_length + acfg.win_length, np.float32))
            sess.flush()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._requested_port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            # shutdown() before close(): closing an fd another thread is
            # blocked in accept() on does not reliably wake that thread
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # not connected / already shut down
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                raise RuntimeError("StreamingServer accept loop failed to "
                                   "exit within 5 s of stop()")
            self._thread = None

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: stop accepting connections, then wait up to
        ``timeout`` seconds for every session in flight to finish (its
        client receives the final transcript).  True when every handler
        completed, False on timeout (stragglers are daemon threads and die
        with the process).  The CLI calls it on SIGTERM."""
        self.stop()  # unbind + join the accept loop; handlers keep running
        deadline = time.monotonic() + timeout
        while True:
            with self._count_lock:
                if self._conns_done >= self._conns_started:
                    return True
            if time.monotonic() >= deadline:
                with self._count_lock:
                    return self._conns_done >= self._conns_started
            time.sleep(0.02)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ------------------------------------------------------------------ client
def stream_wav(host: str, port: int, wav: np.ndarray, chunk_samples: int = 1600):
    """Reference client: stream float32 PCM in int16 chunks; returns
    (partials list, final dict)."""
    pcm16 = np.clip(wav * 32768.0, -32768, 32767).astype("<i2")
    partials = []
    with socket.socket() as s:
        s.connect((host, port))
        f = s.makefile("rb")
        for i in range(0, len(pcm16), chunk_samples):
            chunk = pcm16[i:i + chunk_samples].tobytes()
            s.sendall(struct.pack("<i", len(chunk)) + chunk)
            msg = json.loads(f.readline())
            if "error" in msg:  # slots full, odd payload, bidirectional, ...
                raise RuntimeError(msg["error"])
            partials.append(msg["partial"])
        s.sendall(struct.pack("<i", 0))
        final = json.loads(f.readline())
        if "error" in final:
            raise RuntimeError(final["error"])
    return partials, final


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--decoder", type=str, default="greedy",
                   choices=["greedy", "beam"])
    p.add_argument("--beam_width", type=int, default=4)
    p.add_argument("--normalize", type=str, default=None,
                   choices=["none", "running", "fixed"])
    p.add_argument("--chunk_frames", type=int, default=None)
    p.add_argument("--batch_sessions", type=int, default=0,
                   help="continuous batching: serve up to N concurrent "
                        "sessions with one device tick (greedy, beam, or "
                        "beam + LM/hotword fusion)")
    p.add_argument("--shard_sessions", action="store_true",
                   help="shard --batch_sessions lanes across every visible "
                        "card, a lane group each (lanes must divide evenly; "
                        "--device cpu: one CPU group)")
    p.add_argument("--lm_path", type=str, default=None,
                   help="ARPA / kenlm-binary / pyctcdecode-dir LM for "
                        "shallow fusion (requires --decoder beam; composes "
                        "with --batch_sessions)")
    p.add_argument("--lm_weight", type=float, default=None)
    p.add_argument("--hotwords", type=str, nargs="*", default=None)
    p.add_argument("--hotword_weight", type=float, default=None)
    p.add_argument("--device_lm", type=str, default=None,
                   help="char-level n-gram LM fused on the device inside the "
                        "beam's frame loop (requires --decoder beam; "
                        "mutually exclusive with --lm_path/--hotwords)")
    p.add_argument("--device_lm_weight", type=float, default=0.3)
    p.add_argument("--device_lm_order", type=int, default=3,
                   help="cap the dense char-LM table order (V^order entries)")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA shadow params (requires "
                        "train.ema_decay > 0 at training time)")
    p.add_argument("--average_k", type=int, default=None,
                   help="serve the element-wise mean of the best K retained "
                        "checkpoints")
    p.add_argument("--precision", choices=("fp32", "bf16"), default=None,
                   help="serving compute dtype (beam scores stay fp32); "
                        "default keeps the checkpoint's dtype")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="on SIGTERM/SIGINT: stop accepting, then wait up to "
                        "this many seconds for sessions in flight to finish "
                        "before exiting")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a card)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import signal

    from rnntransducer_tpu_torch.serve import Recognizer

    args = parse_args(argv)
    rec = Recognizer.from_checkpoint(
        args.checkpoint_dir, decoder=args.decoder, beam_width=args.beam_width,
        lm_path=args.lm_path, lm_weight=args.lm_weight, hotwords=args.hotwords,
        hotword_weight=args.hotword_weight, use_ema=args.use_ema,
        average_k=args.average_k, device_lm_path=args.device_lm,
        device_lm_weight=args.device_lm_weight,
        device_lm_order=args.device_lm_order, precision=args.precision,
        device=args.device)
    kw = {"normalize": args.normalize} if args.normalize else {}
    mesh = None
    if args.shard_sessions:
        from rnntransducer_tpu_torch.parallel.mesh import lane_devices
        mesh = lane_devices([rec.device] if rec.device.type == "cpu" else None)
    server = StreamingServer(rec, host=args.host, port=args.port,
                             chunk_frames=args.chunk_frames,
                             batch_sessions=args.batch_sessions, mesh=mesh, **kw)
    server.start()
    lanes = "" if mesh is None else f", {len(mesh)} lane groups"
    print(f"streaming on {args.host}:{server.port} (decoder={args.decoder}, "
          f"device={rec.device}{lanes})", flush=True)

    # graceful preemption: SIGTERM (an orchestrator's replace-me signal) and
    # SIGINT stop the accept loop and drain the sessions in flight, so their
    # clients still receive finals; then the process exits 0
    stop_evt = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop_evt.set())
    stop_evt.wait()
    clean = server.drain(timeout=args.drain_timeout)
    print("drained: all sessions finished" if clean
          else f"drain timeout ({args.drain_timeout}s): exiting with "
               "sessions in flight", flush=True)


if __name__ == "__main__":
    main()
