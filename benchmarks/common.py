"""Shared benchmark helpers (reference benchmarks/ harness conventions:
env-var knobs, bench_results_<device>.json artifacts, RTF/TTFA methodology
per README.md:138-140)."""
from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TEXT = os.environ.get(
    "TEXT",
    "The quick brown fox jumps over the lazy dog while the tired developer "
    "benchmarks text to speech engines on tensor processing units.",
)
LANGUAGE = os.environ.get("LANGUAGE", "English")
MODEL_SIZE = os.environ.get("MODEL_SIZE", "0.6B")
STEPS = int(os.environ.get("BENCH_STEPS", 240))
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))


def model_name(size: str = None) -> str:
    size = (size or MODEL_SIZE).lower().replace("b", "b")
    return os.environ.get("QWEN_TTS_MODEL", f"random:qwen3-tts-{size.lower()}")


def device_tag() -> str:
    try:
        import jax

        return jax.devices()[0].device_kind.replace(" ", "_")
    except Exception:
        return platform.node()


def make_ref_audio(path=None, secs=3.0, sr=24_000) -> str:
    from qwen3tts_tpu.audio.wav import write_wav

    if path is None:
        path = os.path.join(tempfile.gettempdir(), "bench_ref.wav")
    t = np.linspace(0, secs, int(secs * sr), dtype=np.float32)
    wav = (0.25 * np.sin(2 * np.pi * 180 * t)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)
    write_wav(path, wav, sr)
    return path


def load_model(size: str = None, dtype: str = "bf16"):
    from qwen3tts_tpu import FasterQwen3TTS

    t0 = time.time()
    m = FasterQwen3TTS.from_pretrained(model_name(size), dtype=dtype)
    print(f"loaded {model_name(size)} in {time.time()-t0:.1f}s", file=sys.stderr)
    return m


def measure_streaming(model, *, chunk_size=8, steps=STEPS, parity=False, **kw):
    """Returns dict(ttfa_ms, rtf, ms_per_step, steps) for one streaming run."""
    t0 = time.time()
    ttfa = None
    total_steps = 0
    prefill_ms = 0.0
    decode_ms = 0.0
    for audio, sr, tim in model.generate_voice_clone_streaming(
        text=TEXT, language=LANGUAGE, chunk_size=chunk_size,
        max_new_tokens=steps, min_new_tokens=steps, parity_mode=parity, **kw
    ):
        if ttfa is None:
            ttfa = (time.time() - t0) * 1000
            prefill_ms = tim["prefill_ms"]
        decode_ms += tim["decode_ms"]
        total_steps = tim["total_steps_so_far"]
    wall = time.time() - t0
    audio_s = total_steps / 12.0
    return {
        "ttfa_ms": round(ttfa, 1) if ttfa else None,
        "rtf": round(audio_s / wall, 3) if wall > 0 else 0,
        "rtf_model": round(audio_s / (prefill_ms / 1000 + decode_ms / 1000), 3)
        if decode_ms else None,
        "ms_per_step": round(wall / max(total_steps, 1) * 1000, 2),
        "steps": total_steps,
        "wall_s": round(wall, 2),
    }


def write_results(name: str, payload: dict):
    out = Path(os.environ.get("BENCH_OUT", f"bench_results_{device_tag()}.json"))
    existing = json.loads(out.read_text()) if out.exists() else {}
    existing[name] = payload
    out.write_text(json.dumps(existing, indent=2) + "\n")
    print(json.dumps({name: payload}, indent=2))


def invocation_record(*env_keys: str) -> dict:
    """The env knobs that produced a record, so any artifact entry can be
    regenerated from the repo alone."""
    return {k: os.environ[k] for k in env_keys if k in os.environ}
