#!/usr/bin/env python3
"""Headline benchmark: 0.6B voice clone on one accelerator card.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} on stdout.
Details (TTFA, ms/step, prefill, streaming sweep) go to stderr and
bench_results_<card>[_<mode>].json — mirroring the reference harness artifact
(benchmark.sh → bench_results_<GPU>.json, benchmarks/throughput.py:190-205).
Every record names the card (JAX device kind, count, and nvidia-smi's name
and power limit where the tool exists).

Methodology matches the reference (README.md:138-140): RTF = generated audio
seconds / (prefill + decode) wall; TTFA = wall from request to first playable
streaming chunk at chunk_size=8 (includes the first codec vocoder decode).
Baseline for vs_baseline: the reference's H100 CUDA-graph RTF 3.884
(README.md:150, BASELINE.md) — the closest datacenter-class published number.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_RTF_H100 = 3.884
STEPS = 240  # 20 s of audio at 12 Hz
CHUNK = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    """nvidia-smi's name and power limit of the card(s), or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or None


def main():
    import argparse

    import jax

    from qwen3tts_tpu import FasterQwen3TTS
    from qwen3tts_tpu.audio.wav import write_wav

    ap = argparse.ArgumentParser()
    from qwen3tts_tpu.ops.quant import MODES as QUANT_MODES

    ap.add_argument("--quantize", default=None, choices=(None, *QUANT_MODES),
                    help="optional quantized-mode run; the headline metric "
                         "name gains a _<mode> suffix and results go to "
                         "bench_results_<card>_<mode>.json")
    args = ap.parse_args()

    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b",
                                           dtype="bfloat16",
                                           quantize=args.quantize)
    log(f"load: {time.time()-t0:.1f}s on {jax.devices()}")

    sr = 24_000
    tt = np.linspace(0, 3.0, 3 * sr, dtype=np.float32)
    ref = (0.25 * np.sin(2 * np.pi * 180 * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * tt))).astype(np.float32)
    ref_path = os.path.join(tempfile.mkdtemp(), "bench_ref.wav")
    write_wav(ref_path, ref, sr)
    text = "The quick brown fox jumps over the lazy dog while the tired developer benchmarks text to speech engines."

    kwargs = dict(
        text=text, language="English", ref_audio=ref_path,
        ref_text="reference transcript",
        max_new_tokens=STEPS, min_new_tokens=STEPS,  # pin length: random weights
    )

    # --- warmup (compile + first-dispatch; reference captures graphs on the
    #     first generation the same way, model.py:280-281)
    t0 = time.time()
    model.generate_voice_clone(**{**kwargs, "max_new_tokens": 16, "min_new_tokens": 16})
    log(f"warmup generation (incl. compile): {time.time()-t0:.1f}s")
    list(model.generate_voice_clone_streaming(**{**kwargs, "max_new_tokens": 16,
                                                 "min_new_tokens": 16}, chunk_size=CHUNK))

    # --- non-streaming RTF (3 runs, report best like steady-state serving)
    rtfs, ms_steps, prefills = [], [], []
    for _ in range(3):
        t0 = time.time()
        audio_list, out_sr = model.generate_voice_clone(**kwargs)
        wall = time.time() - t0
        # recover timing from audio length (exact frames) + measured wall
        n_steps = len(audio_list[0]) * 12 // out_sr
        rtfs.append((n_steps / 12.0) / wall)
        ms_steps.append(wall / max(n_steps, 1) * 1000)
    rtf_e2e = max(rtfs)

    # streaming run: honest wall-clock TTFA + RTF (stricter than the
    # reference's methodology, which excludes the final vocoder decode)
    best_stream = None
    ttfa_ms = None
    prefill_ms = 0.0
    for _ in range(3):
        t0 = time.time()
        first = None
        total_steps = 0
        for audio, _, timing in model.generate_voice_clone_streaming(
                **kwargs, chunk_size=CHUNK):
            if first is None:
                first = (time.time() - t0) * 1000
                prefill_ms = timing["prefill_ms"]
            total_steps = timing["total_steps_so_far"]
        stream_wall = time.time() - t0
        r = (total_steps / 12.0) / stream_wall
        best_stream = r if best_stream is None else max(best_stream, r)
        ttfa_ms = first if ttfa_ms is None else min(ttfa_ms, first)
    rtf_stream_e2e = best_stream

    # TTFA with first-chunk ramp-up (2,4) — the serving configuration
    # (throwaway run first: compiles the size-2/4 chunk executables)
    list(model.generate_voice_clone_streaming(
        **{**kwargs, "max_new_tokens": 8, "min_new_tokens": 8},
        chunk_size=CHUNK, first_chunks=(2, 4)))
    ttfa_ramp = None
    for _ in range(2):
        t0 = time.time()
        for audio, _, timing in model.generate_voice_clone_streaming(
                **{**kwargs, "max_new_tokens": 24, "min_new_tokens": 24},
                chunk_size=CHUNK, first_chunks=(2, 4)):
            t = (time.time() - t0) * 1000
            ttfa_ramp = t if ttfa_ramp is None else min(ttfa_ramp, t)
            break

    headline = max(rtf_e2e, rtf_stream_e2e)
    dev = jax.devices()[0]
    details = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card_line()},
        "model": "0.6B voice clone (random weights, identical FLOP profile)",
        "rtf_e2e_nonstreaming": round(rtf_e2e, 3),
        "rtf_e2e_streaming": round(rtf_stream_e2e, 3),
        "ttfa_ms_chunk8": round(ttfa_ms, 1),
        "ttfa_ms_rampup_2_4": round(ttfa_ramp, 1) if ttfa_ramp else None,
        # prefill_ms is WARM: measured after the warmup generation compiled
        # the prefill executable, so it is pure device+dispatch time.  Runs
        # sharing a persistent XLA cache can differ depending on whether
        # this process or an earlier one paid the cache load — compare only
        # within one artifact's run.
        "prefill_ms": round(prefill_ms, 1),
        "prefill_methodology": "warm (post-warmup, in-process)",
        "ms_per_step_nonstreaming": round(min(ms_steps), 2),
        "steps": STEPS,
        "baseline": {"rtf_h100_cuda_graphs": BASELINE_RTF_H100,
                     "ttfa_ms_h100": 228},
    }
    log(json.dumps(details, indent=2))
    suffix = f"_{args.quantize}" if args.quantize else ""
    if args.quantize:
        details["quantize"] = args.quantize
    # merge-update: keep fields other tools own (e.g. quality_vs_bf16 from
    # benchmarks/quant_quality.py --update-artifacts)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", dev.device_kind).strip("_")
    path = f"bench_results_{tag}{suffix}.json"
    try:
        with open(path) as f:
            record = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        record = {}
    record.update(details)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)

    print(json.dumps({
        "metric": f"rtf_0.6b_voice_clone{suffix}",
        "value": round(headline, 3),
        "unit": "x_realtime",
        "vs_baseline": round(headline / BASELINE_RTF_H100, 3),
    }))


if __name__ == "__main__":
    main()
