"""Batch collation with static bucket shapes (port of
``rnntransducer_tpu/data/collate.py``).

Pads features or waveforms and labels, builds the prediction network's
input by prepending the blank / pad token to each target, and emits int32
lengths, padded to the bucket's fixed shape.  The feature and waveform
copies go through the repository's native threaded packer
(``native/batch_pack.cpp``), compiled with ``g++`` at first use into
``build/native/libbatch_pack-<hash>.so`` at the root of the checkout and
bound with ``ctypes``; where no toolchain is there, numpy does the same.
This is host code, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "batch_pack.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
_pack_lib = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libbatch_pack-{digest}.so"


def _build_pack_lib(so: Path) -> None:
    # built under a process-private name and renamed, so that concurrent
    # first calls never load a half-written library
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
                    "-o", tmp, str(_SOURCE)], check=True, capture_output=True)
    os.replace(tmp, so)


def _load_pack_lib():
    """The native threaded batch packer, or False where it cannot be built
    (then numpy packs)."""
    global _pack_lib
    if _pack_lib is not None:
        return _pack_lib
    try:
        so = _library_path()
        if not so.exists():
            _build_pack_lib(so)
        lib = ctypes.CDLL(str(so))
        lib.pack_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.pack_quantize_wav_i16.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        _pack_lib = lib
    except (OSError, AttributeError, subprocess.CalledProcessError):
        _pack_lib = False
    return _pack_lib


def pack_features(arrays: Sequence[np.ndarray], max_rows: int, cols: int,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """Pack variable-length (rows_i, cols) float32 arrays into a zero-padded
    (B, max_rows, cols) buffer — native threaded copy when available."""
    B = len(arrays)
    out = np.empty((B, max_rows, cols), np.float32)
    if n_threads is None:
        # thread spawn only pays for itself on large buffers (memcpy-bound)
        n_threads = 4 if out.nbytes >= 64 * 1024 * 1024 else 1
    lib = _load_pack_lib()
    arrays = [np.ascontiguousarray(a[:max_rows], np.float32) for a in arrays]
    if lib:
        ptrs = (ctypes.c_void_p * B)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
        rows = np.asarray([a.shape[0] for a in arrays], np.int32)
        lib.pack_batch_f32(ptrs, rows.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), B, max_rows, cols,
            out.ctypes.data_as(ctypes.c_void_p), n_threads)
        return out
    out.fill(0.0)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


def collate(items: Sequence[dict], max_frames: int, max_labels: int,
            pad_id: int = 0, n_mels: Optional[int] = None) -> Dict[str, np.ndarray]:
    """items: dicts with 'feats' (T, n_mels) float32 and 'labels' (U,) ints.
    Returns fixed-shape arrays: feats (B, max_frames, M), feat_lengths,
    text_in (B, max_labels+1) blank-prepended, text_lengths, targets
    (B, max_labels), target_lengths."""
    B = len(items)
    M = items[0]["feats"].shape[-1] if n_mels is None else n_mels
    feat_arrays = []
    feat_lengths = np.zeros((B,), np.int32)
    targets = np.full((B, max_labels), pad_id, np.int32)
    target_lengths = np.zeros((B,), np.int32)
    text_in = np.full((B, max_labels + 1), pad_id, np.int32)

    for i, it in enumerate(items):
        f = np.asarray(it["feats"], np.float32)
        lab = np.asarray(it["labels"], np.int32)
        if f.shape[-1] != M:
            raise ValueError(f"feature dim {f.shape[-1]} != configured n_mels {M}")
        feat_arrays.append(f)
        feat_lengths[i] = min(f.shape[0], max_frames)
        u = min(len(lab), max_labels)
        targets[i, :u] = lab[:u]
        target_lengths[i] = u
        # blank-prepended; text_len == target_len + 1
        text_in[i, 1:u + 1] = lab[:u]
    # the feature copy is the bulk of collate time: the native packer
    feats = pack_features(feat_arrays, max_frames, M)

    return {
        "feats": feats,
        "feat_lengths": feat_lengths,
        "text_in": text_in,
        "text_lengths": target_lengths + 1,
        "targets": targets,
        "target_lengths": target_lengths,
    }


def pack_waveforms(arrays: Sequence[np.ndarray], max_samples: int,
                   n_threads: int = 1) -> np.ndarray:
    """Pack variable-length (S_i,) float32 waveforms into a zero-padded
    (B, max_samples) float32 buffer (native memcpy when available)."""
    B = len(arrays)
    lib = _load_pack_lib()
    arrays = [np.ascontiguousarray(a[:max_samples], np.float32)
              for a in arrays]
    if lib:
        out = np.empty((B, max_samples), np.float32)
        ptrs = (ctypes.c_void_p * B)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
        rows = np.asarray([a.shape[0] for a in arrays], np.int32)
        # a waveform is a (S, 1) feature matrix to the row packer
        lib.pack_batch_f32(ptrs, rows.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), B, max_samples, 1,
            out.ctypes.data_as(ctypes.c_void_p), n_threads)
        return out
    out = np.zeros((B, max_samples), np.float32)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


def quantize_waveforms(arrays: Sequence[np.ndarray], max_samples: int,
                       n_threads: int = 1):
    """Pack waveforms as (B, max_samples) int16 + per-row float32 scales
    (wav[b] ~= int16[b] * scale[b], 16-bit precision): half the host-to-device
    bytes of the raw-PCM training path.  One native pass
    (``pack_quantize_wav_i16``), or numpy in two."""
    B = len(arrays)
    arrays = [np.ascontiguousarray(a[:max_samples], np.float32)
              for a in arrays]
    lib = _load_pack_lib()
    if lib:
        out = np.empty((B, max_samples), np.int16)
        scales = np.empty((B,), np.float32)
        ptrs = (ctypes.c_void_p * B)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
        rows = np.asarray([a.shape[0] for a in arrays], np.int32)
        lib.pack_quantize_wav_i16(
            ptrs, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            B, max_samples, out.ctypes.data_as(ctypes.c_void_p),
            scales.ctypes.data_as(ctypes.c_void_p), n_threads)
        return out, scales
    out = np.zeros((B, max_samples), np.int16)
    scales = np.zeros((B,), np.float32)
    for i, a in enumerate(arrays):
        peak = float(np.max(np.abs(a))) if a.size else 0.0
        scale = peak / 32767.0 if peak > 0 else 0.0
        scales[i] = scale
        if scale > 0:
            out[i, :a.shape[0]] = np.round(a / scale).astype(np.int16)
    return out, scales


def collate_waveforms(items: Sequence[dict], max_samples: int, max_labels: int,
                      pad_id: int = 0,
                      transfer_dtype: str = "float32") -> Dict[str, np.ndarray]:
    """Raw-waveform variant for the on-device frontend path: items carry
    'wav' (S,) float32 + 'labels'.

    ``transfer_dtype="int16"`` ships the batch as peak-scaled int16 PCM plus a
    (B,) 'wav_scale' column (dequantized on device by the training step) —
    half the host-to-device bytes at 16-bit precision, which per-utterance
    mean-var normalization absorbs."""
    B = len(items)
    wav_arrays = []
    wav_lengths = np.zeros((B,), np.int32)
    targets = np.full((B, max_labels), pad_id, np.int32)
    target_lengths = np.zeros((B,), np.int32)
    text_in = np.full((B, max_labels + 1), pad_id, np.int32)
    for i, it in enumerate(items):
        w = np.asarray(it["wav"], np.float32)
        lab = np.asarray(it["labels"], np.int32)
        u = min(len(lab), max_labels)
        wav_arrays.append(w)
        wav_lengths[i] = min(len(w), max_samples)
        targets[i, :u] = lab[:u]
        target_lengths[i] = u
        text_in[i, 1:u + 1] = lab[:u]
    out = {
        "wav_lengths": wav_lengths,
        "text_in": text_in,
        "text_lengths": target_lengths + 1,
        "targets": targets,
        "target_lengths": target_lengths,
    }
    if transfer_dtype == "int16":
        wav, scales = quantize_waveforms(wav_arrays, max_samples)
        out["wav"], out["wav_scale"] = wav, scales
    elif transfer_dtype == "float32":
        out["wav"] = pack_waveforms(wav_arrays, max_samples)
    else:
        raise ValueError(f"unknown wav transfer_dtype {transfer_dtype!r} "
                         "(use 'float32' or 'int16')")
    return out
