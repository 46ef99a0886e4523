"""Per-model-size certification artifact: bf16 + int8, ramped TTFA, chunk
sweep — one JSON per size.

Usage:
  MODEL_SIZE=1.7B BENCH_OUT=bench_results_1.7b.json \
      python benchmarks/model_cert.py [--modes bf16,int8] [--chunks 1,4,8]

Reference analog: the README 1.7B table (README.md:152-160).
"""
from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from common import (LANGUAGE, MODEL_SIZE, STEPS, TEXT, make_ref_audio,  # noqa: E402
                    measure_streaming, model_name, write_results)


def measure_ramped_ttfa(model, ref, chunk_size=8, tries=3):
    """Best wall-clock TTFA with the serving first_chunks=(2,4) ramp."""
    kw = dict(text=TEXT, language=LANGUAGE, ref_audio=ref,
              ref_text="reference transcript", chunk_size=chunk_size,
              first_chunks=(2, 4))
    # compile the ramp chunk sizes
    list(model.generate_voice_clone_streaming(
        **kw, max_new_tokens=8, min_new_tokens=8))
    best = None
    for _ in range(tries):
        t0 = time.time()
        for _audio, _sr, _t in model.generate_voice_clone_streaming(
                **kw, max_new_tokens=24, min_new_tokens=24):
            ttfa = (time.time() - t0) * 1000
            best = ttfa if best is None else min(best, ttfa)
            break
    return round(best, 1) if best else None


def cert_mode(mode: str, chunks, steps: int):
    from qwen3tts_tpu import FasterQwen3TTS

    from qwen3tts_tpu.ops.quant import MODES as QUANT_MODES

    if mode != "bf16" and mode not in QUANT_MODES:
        raise ValueError(
            f"unknown mode {mode!r}; expected bf16 or one of {QUANT_MODES}")
    kw = {"quantize": mode} if mode in QUANT_MODES else {}
    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained(model_name(), dtype="bf16", **kw)
    load_s = time.time() - t0
    ref = make_ref_audio()
    skw = dict(ref_audio=ref, ref_text="reference transcript")

    rec = {"load_s": round(load_s, 1), "chunk_sweep": {}}
    for cs in chunks:
        measure_streaming(model, chunk_size=cs, steps=max(cs * 2, 8), **skw)
        run = measure_streaming(model, chunk_size=cs, steps=steps, **skw)
        rec["chunk_sweep"][str(cs)] = run
        print(f"  [{mode}] chunk {cs}: rtf={run['rtf']} ttfa={run['ttfa_ms']}",
              file=sys.stderr)
    rec["best_rtf"] = max(r["rtf"] for r in rec["chunk_sweep"].values())
    rec["ttfa_ms_rampup_2_4"] = measure_ramped_ttfa(model, ref)
    print(f"  [{mode}] ramped ttfa: {rec['ttfa_ms_rampup_2_4']}",
          file=sys.stderr)
    del model
    gc.collect()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="bf16,int8")
    ap.add_argument("--chunks", default="1,4,8")
    ap.add_argument("--steps", type=int, default=min(STEPS, 120))
    args = ap.parse_args()
    chunks = [int(c) for c in args.chunks.split(",")]

    out = {"model": model_name(), "size": MODEL_SIZE}
    for mode in args.modes.split(","):
        mode = mode.strip()
        print(f"=== {MODEL_SIZE} {mode} ===", file=sys.stderr)
        out[mode] = cert_mode(mode, chunks, args.steps)
    write_results("model_cert", out)


if __name__ == "__main__":
    main()
