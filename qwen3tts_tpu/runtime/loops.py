"""Decode loops: non-streaming, streaming, and parity paths.

Orchestrates Engine prefill + chunked decode.  Timing-dict contracts match the
reference exactly (generate.py:205-211, streaming.py:162-169) so benchmarks
and the app layer carry over unchanged.

Latency design: the host loop is *pipelined* — the next decode chunk is
dispatched BEFORE the current chunk's results are read back, and all of a
chunk's outputs come home in ONE fused ``jax.device_get``.  JAX's async
dispatch queues the next chunk on-device while the host handles audio, so
per-call dispatch latency is hidden.  After
EOS the one speculative chunk exits its while_loop immediately (token==EOS
⇒ zero iterations), so the overshoot costs nothing.  The reference instead
pays one ``token.item()`` sync per decode step (generate.py:149-150).
"""
from __future__ import annotations

import time
from typing import Dict, Generator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.predictor import SamplingPolicy
from .engine import Engine, GenerationPolicy, TTH_BUCKETS, bucket_for

Frames = np.ndarray  # [steps, 16] int32


def _pad_tth(tth: jnp.ndarray, tpe: jnp.ndarray, bucketed: bool) -> Tuple[jnp.ndarray, int]:
    """Pad trailing-text hiddens to a bucket with the tts_pad embedding
    (reference model.py:537-551 pads with tts_pad_embed)."""
    B, T, H = tth.shape
    Tb = bucket_for(max(T, 1), TTH_BUCKETS) if bucketed else max(T, 1)
    if Tb > T:
        pad = jnp.broadcast_to(tpe, (B, Tb - T, H))
        tth = jnp.concatenate([tth, pad], axis=1)
    return tth, T


def _chunk_iter(
    engine: Engine,
    state: Dict,
    tth: jnp.ndarray,
    tth_len,
    tpe: jnp.ndarray,
    policy: GenerationPolicy,
    pred_policy: SamplingPolicy,
    chunk_size: int,
    max_new_tokens: int,
    first_chunks: Tuple[int, ...] = (),
):
    """Yields (frames_np [n,16], done) with 1-deep pipelining: chunk k+1 is
    dispatched before chunk k is read.  ``first_chunks`` optionally ramps the
    first chunk sizes up (e.g. (2, 4) before steady chunk_size) so the first
    playable audio leaves earlier — a TTFA lever the reference's fixed
    chunk_size doesn't have (README.md:194-205 trades TTFA vs RTF globally)."""
    sizes = list(first_chunks) + [chunk_size]

    def size_at(i):
        return sizes[min(i, len(sizes) - 1)]

    tth_len_dev = jnp.asarray(tth_len, jnp.int32)  # scalar or [B] per-row
    knobs = engine.knobs(policy, pred_policy)
    emitted = 0
    i = 0
    pending = engine.decode_chunk(state, tth, tth_len_dev, tpe, policy,
                                  pred_policy, size_at(0), knobs=knobs)
    while True:
        state, frames, n, lens, done = pending
        may_continue = emitted + size_at(i) < max_new_tokens
        if may_continue:
            # speculative dispatch: enqueued on-device before we block on k
            pending = engine.decode_chunk(state, tth, tth_len_dev, tpe, policy,
                                          pred_policy, size_at(i + 1), knobs=knobs)
        frames_np, n_val, lens_np, done_val = jax.device_get(
            (frames, n, lens, done))  # 1 sync
        n_val = min(int(n_val), max_new_tokens - emitted)
        emitted += n_val
        done_val = bool(done_val) or emitted >= max_new_tokens
        finished = done_val or not may_continue or n_val == 0
        if finished:
            # recycle the final KV buffer (from the last dispatched chunk)
            engine.release(pending[0] if may_continue else state)
        yield frames_np[:, :n_val], np.minimum(lens_np, n_val), done_val
        if finished:
            return
        i += 1


def fast_generate(
    engine: Engine,
    talker_input_embeds: jnp.ndarray,  # [B, T, H]
    trailing_text_hiddens: jnp.ndarray,  # [B, Ttth, H]
    tts_pad_embed: jnp.ndarray,  # [B, 1, H]
    *,
    key: jax.Array,
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    device_chunk: int = 16,
    bucketed: bool = True,
) -> Tuple[Optional[Frames], Dict]:
    """Non-streaming generation.  Returns ([steps,16] codec ids, timing)."""
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed)
    state = engine.prefill(talker_input_embeds, key, policy, bucketed=bucketed)
    jax.block_until_ready(state["token"])
    t_prefill = time.time() - t0

    t1 = time.time()
    chunks = []
    for frames_np, lens, done in _chunk_iter(
        engine, state, tth, tth_len, tts_pad_embed, policy, pred_policy,
        device_chunk, max_new_tokens,
    ):
        if lens[0]:
            chunks.append(frames_np[0, : lens[0]])
    t_decode = time.time() - t1

    steps = sum(c.shape[0] for c in chunks)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
    }
    if not chunks:
        return None, timing
    return np.concatenate(chunks, axis=0), timing


def fast_generate_streaming(
    engine: Engine,
    talker_input_embeds: jnp.ndarray,
    trailing_text_hiddens: jnp.ndarray,
    tts_pad_embed: jnp.ndarray,
    *,
    key: jax.Array,
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
    bucketed: bool = True,
    first_chunks: Tuple[int, ...] = (),
) -> Generator[Tuple[Frames, Dict], None, None]:
    """Streaming generation: yields ([chunk_steps,16], timing) every chunk.

    Pipelined: while the consumer vocodes chunk k, chunk k+1 is already
    running on-device.  Timing keys match the reference (streaming.py:162-169).
    """
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed)
    state = engine.prefill(talker_input_embeds, key, policy, bucketed=bucketed)
    jax.block_until_ready(state["token"])
    t_prefill = time.time() - t0

    total_steps = 0
    chunk_count = 0
    chunk_start = time.time()
    for frames_np, lens, done in _chunk_iter(
        engine, state, tth, tth_len, tts_pad_embed, policy, pred_policy,
        chunk_size, max_new_tokens, first_chunks=first_chunks,
    ):
        frames_np = frames_np[0, : lens[0]]
        n = frames_np.shape[0]
        if n == 0:
            break
        total_steps += n
        chunk_decode = time.time() - chunk_start
        yield frames_np, {
            "chunk_index": chunk_count,
            "chunk_steps": n,
            "prefill_ms": t_prefill * 1000 if chunk_count == 0 else 0,
            "decode_ms": chunk_decode * 1000,
            "total_steps_so_far": total_steps,
            "is_final": done,
        }
        chunk_count += 1
        chunk_start = time.time()


def _auto_pipeline_depth(chunk_size: int) -> int:
    """In-flight decode chunks beyond the one being fetched.  Small chunks
    amortize the per-chunk host round trip over less device work, so they
    need a deeper dispatch queue to keep the device busy; at chunk 8+ one
    speculative chunk already hides it.  Override with
    QWEN3TTS_PIPELINE_DEPTH."""
    import os

    env = os.environ.get("QWEN3TTS_PIPELINE_DEPTH")
    if env:
        return max(1, int(env))
    return max(1, min(8, round(30.0 / (chunk_size * 6.0)) + 1))


def fast_generate_streaming_audio(
    engine: Engine,
    vocoder,
    talker_input_embeds: jnp.ndarray,
    trailing_text_hiddens: jnp.ndarray,
    tts_pad_embed: jnp.ndarray,
    *,
    key: jax.Array,
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
    bucketed: bool = True,
    first_chunks: Tuple[int, ...] = (),
    ref_codes: Optional[np.ndarray] = None,
    pipeline_depth: Optional[int] = None,
) -> Generator[Tuple[Frames, np.ndarray, Dict], None, None]:
    """Streaming generation with the FUSED decode+vocode device program:
    yields (codec_chunk [n,16], audio [n*spf] f32, timing) per chunk.

    One dispatch + one fused device_get per chunk (Engine.chunk_vocode)
    instead of the 3-4 round trips of the split path.  ``ref_codes`` primes
    the vocoder's sliding context (ICL voice clone) exactly like
    StreamDecoder.feed on the reference path.

    Dispatch is pipelined ``pipeline_depth`` chunks deep (auto by chunk
    size): chunk k's fetch overlaps the device running chunks k+1..k+d and
    their host transfers (started early via ``copy_to_host_async``), so the
    per-chunk round trip stops bounding throughput at small chunk sizes
.  Post-EOS speculative chunks exit their while_loop in zero
    iterations, so the overshoot stays free.

    The prefill is NOT host-synced: its result flows straight into the first
    chunk's dispatch, so device prefill overlaps the host's chunk dispatch
    instead of costing a round trip.  The first chunk's ``prefill_ms``
    therefore reports host-side prompt dispatch time only; the device
    prefill cost lands in that chunk's ``decode_ms`` (and in TTFA, which is
    what streaming callers actually experience)."""
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed)
    state = engine.prefill(talker_input_embeds, key, policy, bucketed=bucketed)
    t_prefill = time.time() - t0

    spf = vocoder.spf
    voc_state = engine.vocode_stream_init(vocoder)
    if ref_codes is not None and len(ref_codes):
        # ICL: reference codec frames prime the codec's streaming state
        # (conv tails + attention windows), audio discarded — the stateful
        # analog of StreamDecoder.feed(ref_codes)
        voc_state = engine.vocode_prime(vocoder, voc_state, ref_codes)

    sizes = list(first_chunks) + [chunk_size]

    def size_at(i):
        return sizes[min(i, len(sizes) - 1)]

    depth = pipeline_depth or _auto_pipeline_depth(chunk_size)
    tth_len_dev = jnp.asarray(tth_len, jnp.int32)
    knobs = engine.knobs(policy, pred_policy)
    tpe = tts_pad_embed

    from collections import deque

    q: deque = deque()
    cur_state, cur_voc = state, voc_state
    planned = 0  # frames planned across dispatched chunks
    ndisp = 0

    def dispatch_one():
        nonlocal cur_state, cur_voc, planned, ndisp
        out = engine.chunk_vocode(
            vocoder, cur_state, tth, tth_len_dev, tpe,
            policy=policy, pred_policy=pred_policy,
            chunk_size=size_at(ndisp), voc_state=cur_voc, knobs=knobs)
        cur_state, cur_voc = out[0], out[6]
        for arr in (out[1], out[2], out[4], out[5]):  # frames, n, done, audio
            try:
                arr.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
        q.append(out)
        planned += size_at(ndisp)
        ndisp += 1

    dispatch_one()  # chunk 0
    emitted = 0
    chunk_count = 0
    chunk_start = time.time()
    while q:
        # keep the pipeline full, growing ≤2 dispatches per iteration so the
        # first chunk's fetch (TTFA) is never delayed behind a dispatch burst
        grown = 0
        while planned < max_new_tokens and len(q) <= depth and grown < 2:
            dispatch_one()
            grown += 1
        _, frames, n, lens, done, audio, _ = q.popleft()
        frames_np, n_val, done_val, audio_np = jax.device_get(
            (frames, n, done, audio))  # ONE sync per chunk
        n_val = min(int(n_val), max_new_tokens - emitted)
        emitted += n_val
        done_val = bool(done_val) or emitted >= max_new_tokens
        finished = done_val or n_val == 0 or (not q and planned >= max_new_tokens)
        if finished:
            # recycle the NEWEST KV buffer; in-flight speculative chunks
            # post-EOS are zero-iteration no-ops writing nothing
            engine.release(cur_state)
        if n_val:
            chunk_decode = time.time() - chunk_start
            yield frames_np[0, :n_val], audio_np[: n_val * spf], {
                "chunk_index": chunk_count,
                "chunk_steps": n_val,
                "prefill_ms": t_prefill * 1000 if chunk_count == 0 else 0,
                "decode_ms": chunk_decode * 1000,
                "total_steps_so_far": emitted,
                "is_final": done_val,
            }
            chunk_count += 1
            chunk_start = time.time()
        if finished:
            return


def fast_generate_batch(
    engine: Engine,
    talker_input_embeds: jnp.ndarray,  # [B, T, H] left-padded per row
    trailing_text_hiddens: jnp.ndarray,  # [B, Ttth, H] (pad rows w/ tts_pad)
    tts_pad_embed: jnp.ndarray,  # [B, 1, H]
    *,
    key: jax.Array,
    pad_count: Optional[np.ndarray] = None,  # [B] per-row left-pad
    tth_lens: Optional[np.ndarray] = None,  # [B] true per-row tth lengths
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    device_chunk: int = 16,
) -> Tuple[list, Dict]:
    """Batched decode: B prompts generate together in one engine pass —
    the throughput-per-chip mode the reference does not have (it is strictly
    batch-1, SURVEY §2.4).  Rows finish at their own EOS; garbage frames
    after a row's EOS are dropped via the per-row length counts.

    Returns ([B] list of [steps_b, 16] arrays, timing).  Note: ``tth``
    consumption is indexed by the shared step counter, so per-row trailing
    text stops at ``tth_lens`` via the tts_pad fallback per row... shared
    ``tth_len`` scalar uses max(tth_lens); rows with shorter text get
    tts_pad embeds from their own padded rows (callers pad tth rows with
    tts_pad_embed, so the content is correct per row)."""
    B = talker_input_embeds.shape[0]
    assert engine.batch == B, f"Engine(batch={engine.batch}) vs input B={B}"
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed=True)
    if tth_lens is not None:
        tth_len = np.asarray(tth_lens, np.int32)  # exact per-row text lengths
    state = engine.prefill(talker_input_embeds, key, policy,
                           pred_policy=pred_policy, pad_count=pad_count)
    jax.block_until_ready(state["token"])
    t_prefill = time.time() - t0

    t1 = time.time()
    rows = [[] for _ in range(B)]
    for frames_np, lens, done in _chunk_iter(
        engine, state, tth, tth_len, tts_pad_embed, policy, pred_policy,
        device_chunk, max_new_tokens,
    ):
        for b in range(B):
            if lens[b]:
                rows[b].append(frames_np[b, : lens[b]])
    t_decode = time.time() - t1

    out = [np.concatenate(r, axis=0) if r else np.zeros((0, 16), np.int32)
           for r in rows]
    steps = sum(o.shape[0] for o in out)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
        "batch": B,
    }
    return out, timing


def parity_generate(
    engine: Engine,
    talker_input_embeds: jnp.ndarray,
    trailing_text_hiddens: jnp.ndarray,
    tts_pad_embed: jnp.ndarray,
    *,
    key: jax.Array,
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
) -> Tuple[Optional[Frames], Dict]:
    """Parity path: exact-length (un-bucketed) prefill + per-step decode with
    a host sync every step — mirrors the reference's deliberately-slow
    dynamic-cache parity mode (streaming.py:192-359).  Same math as the fast
    path, so token parity between the two is a correctness invariant
    (reference test layer 3, test_e2e_parity.py:914-1017)."""
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed=False)
    state = engine.prefill(talker_input_embeds, key, policy, bucketed=False)
    jax.block_until_ready(state["token"])
    t_prefill = time.time() - t0

    t1 = time.time()
    frames_list = []
    knobs = engine.knobs(policy, pred_policy)
    for _ in range(max_new_tokens):
        if int(state["token"][0]) == engine.eos_id:
            break
        if int(state["pos"]) >= engine.max_seq_len - 1:
            break
        state, frame = engine.decode_step(
            state, tth, tth_len, tts_pad_embed, policy, pred_policy, knobs=knobs
        )
        frames_list.append(np.asarray(frame))
    t_decode = time.time() - t1

    steps = len(frames_list)
    timing = {
        "prefill_ms": t_prefill * 1000,
        "decode_s": t_decode,
        "steps": steps,
        "ms_per_step": (t_decode / steps * 1000) if steps else 0.0,
        "steps_per_s": (steps / t_decode) if t_decode > 0 else 0.0,
    }
    if not frames_list:
        return None, timing
    return np.concatenate(frames_list, axis=0), timing


def parity_generate_streaming(
    engine: Engine,
    talker_input_embeds: jnp.ndarray,
    trailing_text_hiddens: jnp.ndarray,
    tts_pad_embed: jnp.ndarray,
    *,
    key: jax.Array,
    max_new_tokens: int = 2048,
    policy: GenerationPolicy = GenerationPolicy(),
    pred_policy: SamplingPolicy = SamplingPolicy(),
    chunk_size: int = 8,
) -> Generator[Tuple[Frames, Dict], None, None]:
    """TRUE streaming parity path: the per-step loop of ``parity_generate``,
    yielding every ``chunk_size`` steps as they are produced — chunk k is
    available before step k·chunk_size+1 runs, so its TTFA is real (reference
    parity_generate_streaming, streaming.py:192-359; round 1 faked this by
    slicing a finished generation)."""
    t0 = time.time()
    tth, tth_len = _pad_tth(trailing_text_hiddens, tts_pad_embed, bucketed=False)
    state = engine.prefill(talker_input_embeds, key, policy, bucketed=False)
    jax.block_until_ready(state["token"])
    t_prefill = time.time() - t0

    frames_buf = []
    total_steps = 0
    chunk_count = 0
    chunk_start = time.time()
    knobs = engine.knobs(policy, pred_policy)

    def make_timing(n, done):
        nonlocal chunk_count, chunk_start
        t = {
            "chunk_index": chunk_count,
            "chunk_steps": n,
            "prefill_ms": t_prefill * 1000 if chunk_count == 0 else 0,
            "decode_ms": (time.time() - chunk_start) * 1000,
            "total_steps_so_far": total_steps,
            "is_final": done,
        }
        chunk_count += 1
        chunk_start = time.time()
        return t

    for step in range(max_new_tokens):
        if int(state["token"][0]) == engine.eos_id:
            break
        if int(state["pos"]) >= engine.max_seq_len - 1:
            break
        state, frame = engine.decode_step(
            state, tth, tth_len, tts_pad_embed, policy, pred_policy, knobs=knobs
        )
        frames_buf.append(np.asarray(frame))
        total_steps += 1
        if len(frames_buf) == chunk_size:
            hit_budget = step + 1 >= max_new_tokens
            done = hit_budget or int(state["token"][0]) == engine.eos_id \
                or int(state["pos"]) >= engine.max_seq_len - 1
            chunk = np.concatenate(frames_buf, axis=0)
            frames_buf = []
            yield chunk, make_timing(chunk.shape[0], done)
    if frames_buf:
        chunk = np.concatenate(frames_buf, axis=0)
        yield chunk, make_timing(chunk.shape[0], True)
