"""Serving soak: continuous batching under staggered concurrent load.

The reference serializes requests behind a lock (examples/openai_server.py:71)
— aggregate throughput equals single-stream throughput.  This bench drives
the ContinuousBatcher (requests join/leave the RUNNING batch at chunk
boundaries) with N requests arriving over time and mixed generation lengths,
and records what a serving operator actually cares about:

  - aggregate frames/s and aggregate RTF (audio seconds per wall second)
  - per-request TTFA distribution (p50/p95) incl. queue wait
  - scheduler counters (joined_mid_batch, batches)

Env knobs: MODEL_SIZE, SOAK_REQUESTS, SOAK_BATCH, SOAK_KV_QUANT=1,
SOAK_QUANT=int8|w8a8 (weight quantization), SOAK_SPREAD (arrival-spread
scale, default 1.0; ~0 = all requests arrive at once → measures the
scheduler's saturated ceiling rather than the staggered-arrival profile),
SOAK_RAMP="2,4" (first_chunks TTFA ramp re-run at batch start and after
every mid-batch join), SOAK_TAG (override the artifact record name, e.g.
a light-load TTFA profile with few spread-out requests).
Writes the ``serving_soak[_kvq|_int8|_saturated|_ramp]`` record via the
shared artifact machinery.
"""
from __future__ import annotations

import logging
import math
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from common import (LANGUAGE, invocation_record, make_ref_audio,  # noqa: E402
                    model_name, write_results)

if os.environ.get("QWEN3TTS_BATCH_TRACE", "0") == "1":
    # the scheduler's per-chunk trace is logger.info — surface it
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(relativeCreated)8.0fms %(message)s")

N_REQUESTS = int(os.environ.get("SOAK_REQUESTS", 24))
MAX_BATCH = int(os.environ.get("SOAK_BATCH", 8))
KV_QUANT = os.environ.get("SOAK_KV_QUANT", "0") == "1"
QUANT = os.environ.get("SOAK_QUANT") or None
SPREAD = float(os.environ.get("SOAK_SPREAD", "1.0"))
RAMP = tuple(int(x) for x in os.environ.get("SOAK_RAMP", "").split(",") if x)
CHUNK = 8


def steady_rate(events, t_start, wall):
    """Steady-state frames/s over the middle 70% of the run: excludes the
    fill phase (batch setup + first prefill) and the drain tail where live
    rows < max_batch only because the finite request set ran out — the
    end-to-end frames_per_s understates what a continuous arrival stream
    would sustain."""
    if len(events) < 16:
        return None
    lo, hi = t_start + 0.15 * wall, t_start + 0.85 * wall
    return round(sum(f for t, f in events if lo <= t <= hi) / (hi - lo), 1)


TEXTS = [
    "A short utterance.",
    "A medium length utterance that carries a bit more text to speak aloud.",
    "A considerably longer utterance intended to exercise mixed sequence "
    "lengths inside the shared continuous batch so rows retire at different "
    "times and admissions happen mid-flight.",
]
STEP_BUDGETS = (96, 144, 192)  # 8 / 12 / 16 s of audio at 12 Hz


def main():
    from qwen3tts_tpu import FasterQwen3TTS
    from qwen3tts_tpu.runtime.engine import GenerationPolicy
    from qwen3tts_tpu.runtime.scheduler import ContinuousBatcher

    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained(model_name(), dtype="bf16",
                                           kv_quant=KV_QUANT, quantize=QUANT)
    print(f"load: {time.time()-t0:.1f}s (kv_quant={KV_QUANT}, "
          f"quantize={QUANT})", file=sys.stderr)
    ref = make_ref_audio()

    # EOS suppressed: random weights would EOS at random, destroying the
    # fixed-load comparison; every request runs exactly its budget
    policy = GenerationPolicy(do_sample=True, min_new_tokens=10_000)
    batcher = ContinuousBatcher(model, max_batch=MAX_BATCH, chunk_size=CHUNK,
                                max_new_tokens=max(STEP_BUDGETS), policy=policy,
                                first_chunks=RAMP)
    t0 = time.time()
    # max_tth=64 covers this bench's trailing-hidden lengths with 2 fused
    # compiles instead of all 5 tth buckets (the fused batched decode+vocode
    # program is large; a degraded compile service aborts long warmups).
    # 256 is in the list because the longest TEXTS prompt buckets there —
    # an unwarmed bucket compiles mid-serve and poisons every TTFA
    # (measured 8-13 s of stall; the batcher warns when it happens)
    batcher.warmup(prefill_buckets=(32, 64, 128, 256), max_tth=64)
    print(f"warmup: {time.time()-t0:.1f}s", file=sys.stderr)

    # voice prompt cache warm (not part of the serving measurement)
    h = batcher.submit(TEXTS[0], LANGUAGE, ref, "reference transcript",
                       max_new_tokens=CHUNK)
    for _ in h.chunks():
        pass
    # scheduler counters accumulated so far belong to the warmup request —
    # exclude them so `served` matches `requests` in the record
    stats_before = {k: v for k, v in batcher.stats.items()
                    if isinstance(v, (int, float))}

    results = []
    errors = []
    events = []  # (wall time, frames) per delivered chunk — steady-state calc
    lock = threading.Lock()

    def drive(i, delay):
        time.sleep(delay)
        t_submit = time.time()
        # arriving(): advertise before prompt prep, same as the OpenAI
        # server — a saturated flood's batch then starts full instead of
        # paying one position-gated join per straggler
        with batcher.arriving():
            h = batcher.submit(TEXTS[i % len(TEXTS)], LANGUAGE, ref,
                               "reference transcript",
                               max_new_tokens=STEP_BUDGETS[i % len(STEP_BUDGETS)])
        ttfa = None
        steps = 0
        tim = {}
        try:
            for _audio, _sr, tim in h.chunks():
                if ttfa is None:
                    ttfa = (time.time() - t_submit) * 1000
                with lock:
                    events.append((time.time(),
                                   tim["total_steps_so_far"] - steps))
                steps = tim["total_steps_so_far"]
        except Exception as e:  # failed/cancelled stream: record, don't hang
            with lock:
                errors.append({"i": i, "error": repr(e)})
            return
        with lock:
            results.append({"i": i, "ttfa_ms": ttfa, "steps": steps,
                            "wall_s": time.time() - t_submit,
                            "queue_ms": tim.get("queue_ms", 0.0)})

    rs = np.random.RandomState(0)
    # staggered arrivals; SOAK_SPREAD scales the spacing (0 → all at once)
    delays = np.cumsum(rs.uniform(0.05, 0.6, N_REQUESTS)) * SPREAD
    t_start = time.time()
    threads = [threading.Thread(target=drive, args=(i, float(delays[i])))
               for i in range(N_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    wall = time.time() - t_start
    batcher.close()

    assert len(results) == N_REQUESTS, \
        f"only {len(results)} completed; errors: {errors}"
    total_steps = sum(r["steps"] for r in results)
    ttfas = sorted(r["ttfa_ms"] for r in results)
    payload = {
        "requests": N_REQUESTS,
        "max_batch": MAX_BATCH,
        "kv_quant": KV_QUANT,
        "quantize": QUANT,
        "arrival_spread": SPREAD,
        "chunk_size": CHUNK,
        "total_frames": total_steps,
        "wall_s": round(wall, 2),
        "frames_per_s": round(total_steps / wall, 1),
        "aggregate_rtf": round(total_steps / 12.0 / wall, 2),
        "frames_per_s_steady": steady_rate(events, t_start, wall),
        "ttfa_ms_p50": round(ttfas[len(ttfas) // 2], 1),
        "ttfa_ms_p95": round(
            ttfas[min(len(ttfas) - 1,
                      math.ceil(len(ttfas) * 0.95) - 1)], 1),  # nearest-rank
        "ttfa_ms_max": round(ttfas[-1], 1),
        "per_step_ms_effective": round(wall / total_steps * 1000, 2),
        "first_chunks": list(RAMP),
        "scheduler": {k: (v - stats_before.get(k, 0)
                          if isinstance(v, (int, float)) else v)
                      for k, v in batcher.stats.items()
                      if k != "queue_depth"},
        # how to regenerate this record
        "invocation": invocation_record(
            "MODEL_SIZE", "SOAK_REQUESTS", "SOAK_BATCH", "SOAK_KV_QUANT",
            "SOAK_QUANT", "SOAK_SPREAD", "SOAK_RAMP", "SOAK_TAG",
            "QWEN3TTS_BATCH_PIPELINE", "QWEN3TTS_BATCH_TRACE"),
    }
    tag = "serving_soak"
    if KV_QUANT:
        tag += "_kvq"
    if QUANT:
        tag += f"_{QUANT}"
    if SPREAD < 0.5:
        tag += "_saturated"
    if RAMP:
        tag += "_ramp"
    # non-default geometry gets its own record — a 1.7B or B=16 run must
    # never overwrite the default config's numbers
    from common import MODEL_SIZE
    if MODEL_SIZE.lower() != "0.6b":
        tag += f"_{MODEL_SIZE.lower()}"
    if MAX_BATCH != 8:
        tag += f"_b{MAX_BATCH}"
    tag = os.environ.get("SOAK_TAG", tag)
    write_results(tag, payload)


if __name__ == "__main__":
    main()
