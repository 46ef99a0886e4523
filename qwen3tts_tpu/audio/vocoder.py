"""Chunked streaming vocoder decode with sliding-window left context.

Reference behavior (model.py:737-826): phase-1 accumulated decode until
≥ max(25, chunk_size) frames to calibrate ``samples_per_frame``, then phase-2
sliding window with 25-frame left context, trimming context samples.

Simplification: our codec is strictly causal and emits exactly
``total_upsample`` samples per frame, so no calibration is needed and the
sliding window runs as ONE fixed-shape jitted executable.  Shape bucketing
is done by RIGHT-padding the code sequence and trimming the waveform tail —
exact by causality for any weights (left-pad masking would only be exact
with all-zero biases; see models/codec.py:decode docstring).
Distinct compile count: one per (window bucket), not per length.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import CodecConfig
from ..models import codec as codec_lib

FULL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets=FULL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1])) * buckets[-1]


class Vocoder:
    """Jitted codec decode/encode with shape bucketing.

    ``compute_dtype``: decode-path compute precision.  bf16 (default) runs
    the conv/attention stacks on the bf16 tensor cores with f32 accumulation
    (``preferred_element_type`` in models/codec.py) — the same precision the
    reference runs its speech tokenizer at (whole model loaded bf16,
    model.py:107-112) and ~3x faster than f32 on the streaming window.
    Pass ``jnp.float32`` for maximum waveform fidelity (offline mastering)."""

    def __init__(self, params: Dict, cfg: CodecConfig, context_frames: int = 25,
                 compute_dtype=jnp.bfloat16):
        self.cfg = cfg
        self.context_frames = context_frames
        self.spf = cfg.total_upsample  # samples per frame — exact
        if compute_dtype is not None and compute_dtype != jnp.float32:
            params = jax.tree.map(
                lambda x: x.astype(compute_dtype)
                if hasattr(x, "dtype") and x.dtype == jnp.float32 else x,
                params)
        self.params = params
        self._decode_jit = jax.jit(
            functools.partial(codec_lib.decode, cfg=cfg)
        )
        self._encode_jit = jax.jit(functools.partial(codec_lib.encode, cfg=cfg))
        # stateful-streaming executables are SHARED across all consumers
        # (StatefulStreamDecoder instances, Engine.chunk_vocode priming):
        # per-instance jits would re-trace/recompile on every serving-request
        # admission and grow executable memory without bound
        self._stream_step_jit = jax.jit(
            functools.partial(codec_lib.decode_stream, cfg=cfg),
            donate_argnames=("state",))
        self._stream_init_jit = jax.jit(
            lambda: codec_lib.stream_init(self.params, cfg, 1))
        self._stream_init_b_jit = jax.jit(
            lambda b: codec_lib.stream_init(self.params, cfg, b),
            static_argnums=(0,))
        # splice one row's [1]-batch stream state into a batched state
        # (continuous-batching row admission); ``row`` is traced so one
        # executable serves every row index
        self._scatter_row_jit = jax.jit(
            lambda bs, rs, row: jax.tree.map(
                lambda b, r: b.at[row].set(r[0]), bs, rs),
            donate_argnums=(0,))

    # -- full (bucketed) decode, non-streaming ---------------------------
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [T, 16] → waveform [T*spf] float32."""
        T = codes.shape[0]
        Tb = _bucket(T)
        c = np.zeros((1, Tb, self.cfg.num_quantizers), np.int32)
        c[0, :T] = codes
        wav = self._decode_jit(self.params, codes=jnp.asarray(c))
        return np.asarray(wav[0, : T * self.spf])

    # -- streaming ------------------------------------------------------
    def stream_decoder(self, chunk_size: int) -> "StreamDecoder":
        return StreamDecoder(self, chunk_size)

    def stateful_stream_decoder(self) -> "StatefulStreamDecoder":
        """Exact streaming decoder carrying codec state (no context window);
        see StatefulStreamDecoder."""
        return StatefulStreamDecoder(self)

    # feed-size buckets for arbitrary-length streaming feeds: greedy
    # decomposition bounds compile count while keeping dispatch count low
    # for long reference primings
    STREAM_FEED_SIZES = (64, 32, 16, 8, 4, 2, 1)

    def stream_state(self):
        """Fresh codec streaming state (one fused device program)."""
        return self._stream_init_jit()

    def stream_state_batched(self, batch: int):
        """Fresh batched codec streaming state: one state pytree whose
        leaves carry a leading ``batch`` dim, shared by all serving rows
        (each row has its own ``frame0`` counter)."""
        return self._stream_init_b_jit(batch)

    def scatter_stream_row(self, batched_state, row_state, row: int):
        """Write a single-row ([1]-batch) stream state into row ``row`` of a
        batched state — how the continuous batcher resets/primes a row's
        vocoder on admission.  Donates ``batched_state``; ``row_state`` is
        left intact (it may be a cached primed voice state)."""
        return self._scatter_row_jit(batched_state, row_state,
                                     jnp.int32(row))

    def stream_feed(self, state, codes: np.ndarray, collect_audio: bool = True):
        """Feed frames through the streaming state in bounded-shape chunks.
        Returns (audio float32 [n*spf] or None, state').  With
        ``collect_audio=False`` nothing is fetched to the host — the
        dispatches pipeline asynchronously (ICL priming discards audio)."""
        codes = np.asarray(codes, np.int32)
        n = len(codes)
        outs = []
        i = 0
        while i < n:
            step = next(s for s in self.STREAM_FEED_SIZES if s <= n - i)
            wav, state = self._stream_step_jit(
                self.params, state=state,
                codes=jnp.asarray(codes[None, i:i + step]))
            if collect_audio:
                outs.append(wav)
            i += step
        if not collect_audio:
            return None, state
        return (np.concatenate([np.asarray(w[0]) for w in outs])
                if outs else np.zeros((0,), np.float32)), state

    # -- encode ---------------------------------------------------------
    def encode(self, wav: np.ndarray) -> np.ndarray:
        """waveform [N] @ cfg.sample_rate → codes [T, 16].

        Bucketed on frame count; the trailing partial frame is dropped (codec
        frames are exact ``total_upsample``-sample units)."""
        T = len(wav) // self.spf
        if T == 0:
            return np.zeros((0, self.cfg.num_quantizers), np.int32)
        Tb = _bucket(T)
        buf = np.zeros((1, Tb * self.spf), np.float32)
        # right-pad: encoder is causal so frames [0,T) are unaffected
        buf[0, : T * self.spf] = wav[: T * self.spf]
        codes = self._encode_jit(self.params, wav=jnp.asarray(buf))
        return np.asarray(codes[0, :T])


class StreamDecoder:
    """Stateful per-generation streaming decoder (one fixed-shape executable).

    Mirrors the reference's hybrid decode (model.py:769-826) but exact:
    every call decodes a ``context+chunk`` window (right-padded to the fixed
    window length when not enough new frames) and returns only the new
    samples — exact by strict causality.
    """

    def __init__(self, vocoder: Vocoder, chunk_size: int):
        self.v = vocoder
        self.window = vocoder.context_frames + chunk_size
        self.history: List[np.ndarray] = []  # all frames so far [n,16]
        self.n_emitted_frames = 0

    def feed(self, new_codes: np.ndarray) -> np.ndarray:
        """new_codes [n,16] → new audio samples [n*spf] float32."""
        n_new = new_codes.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.float32)
        self.history.append(np.asarray(new_codes, np.int32))
        all_codes = np.concatenate(self.history, axis=0)
        total = all_codes.shape[0]

        W = self.window
        if n_new > W:  # a single huge chunk: decode it fully (bucketed path)
            wav = self.v.decode(all_codes)
            out = wav[self.n_emitted_frames * self.v.spf :]
            self.n_emitted_frames = total
            return out

        win = all_codes[max(0, total - W) :]
        n_valid = win.shape[0]
        n_ctx = n_valid - n_new
        buf = np.zeros((1, W, self.v.cfg.num_quantizers), np.int32)
        buf[0, :n_valid] = win
        wav = self.v._decode_jit(self.v.params, codes=jnp.asarray(buf))
        out = np.asarray(wav[0, n_ctx * self.v.spf : n_valid * self.v.spf])
        self.n_emitted_frames = total
        return out


class StatefulStreamDecoder:
    """Streaming decoder over models/codec.py:decode_stream — carries conv
    tails + attention windows instead of re-decoding a context window, so
    each feed() does only its own frames' work and the concatenated output
    is SAMPLE-EXACT vs a full decode (the window scheme was approximate:
    the codec pre-transformer's 72-frame sliding attention over 4 layers
    exceeds the 25-frame context).

    Drop-in for StreamDecoder.feed(); compile count is bounded by chunking
    arbitrary feeds into a fixed size set.  All executables are shared at
    the Vocoder level — constructing instances is free."""

    def __init__(self, vocoder: Vocoder):
        self.v = vocoder
        self.state = vocoder.stream_state()

    def feed(self, new_codes: np.ndarray) -> np.ndarray:
        audio, self.state = self.v.stream_feed(self.state, new_codes,
                                               collect_audio=True)
        return audio

