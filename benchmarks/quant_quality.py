"""Quantization quality gate: bf16 vs int8 / w8a8 / kv_quant fidelity.

The speed headlines for the int8 modes live in bench.py's
bench_results_<card>_<mode>.json; this bench adds the missing axis: same
weights, same seed, greedy codebook-0, fixed length — then waveform SNR,
log-mel distance, and codec-token agreement of each quantized mode against
the bf16 run.  With ``--update-artifacts`` the ``quality_vs_bf16`` record is
patched into the existing speed-artifact JSONs so the README's int8 claims
can cite fidelity next to RTF.

Reference analog: committed parity sample WAVs + seeds
(samples/parity/README.md) — here made numeric and assertable.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from common import (LANGUAGE, TEXT, device_tag, load_model,  # noqa: E402
                    make_ref_audio, model_name, write_results)

from qwen3tts_tpu.utils.quality import (  # noqa: E402
    fixed_generation, log_mel_distance, teacher_forced_quality,
    token_agreement, waveform_snr_db)

def artifact_for_mode(mode: str):
    """Speed-artifact JSON patched with quality_vs_bf16 (bench.py naming:
    bench_results_<card>_<mode>.json).  None for modes without a speed
    artifact (bf16 is the reference; kv_quant quality lives in the
    quant_quality record only)."""
    from qwen3tts_tpu.ops.quant import MODES as QUANT_MODES

    return f"bench_results_{device_tag()}_{mode}.json" if mode in QUANT_MODES else None


def build_model(mode: str):
    from qwen3tts_tpu import FasterQwen3TTS

    from qwen3tts_tpu.ops.quant import MODES as QUANT_MODES

    kw = {}
    if mode in QUANT_MODES:
        kw["quantize"] = mode
    elif mode == "kv_quant":
        kw["kv_quant"] = True
    elif mode != "bf16":
        raise ValueError(mode)
    return FasterQwen3TTS.from_pretrained(model_name(), dtype="bf16", **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--modes", default="int8,w8a8,kv_quant")
    ap.add_argument("--update-artifacts", action="store_true",
                    help="patch quality_vs_bf16 into the per-mode speed "
                         "artifact JSONs at the repo root")
    args = ap.parse_args()

    ref_audio = make_ref_audio()
    print(f"reference run: bf16 {model_name()} ({args.steps} steps)",
          file=sys.stderr)
    # the bf16 model stays live for the whole run: the teacher-forced
    # comparison needs its logits against every quantized mode (device
    # memory holds the bf16 0.6B + one quantized copy comfortably)
    m = load_model(dtype="bf16")
    ids_ref, wav_ref = fixed_generation(
        m, TEXT, ref_audio, "bench reference", LANGUAGE, args.steps, args.seed)
    sr = m.sample_rate

    results = {}
    for mode in args.modes.split(","):
        mode = mode.strip()
        if not mode:
            continue
        print(f"quality run: {mode}", file=sys.stderr)
        mq = build_model(mode)
        ids_q, wav_q = fixed_generation(
            mq, TEXT, ref_audio, "bench reference", LANGUAGE, args.steps,
            args.seed)
        rec = {
            "steps": args.steps,
            "waveform_snr_db": round(waveform_snr_db(wav_ref, wav_q), 2),
            "log_mel_dist": round(log_mel_distance(wav_ref, wav_q, sr), 4),
        }
        rec.update(token_agreement(ids_ref, ids_q))
        # token-matched fidelity (the primary claim): both models over the
        # bf16 run's code history — quantization noise without free-running
        # divergence
        rec["teacher_forced"] = teacher_forced_quality(
            m, mq, text=TEXT, ref_audio=ref_audio, ref_text="bench reference",
            language=LANGUAGE, codes=ids_ref)
        results[mode] = rec
        del mq
        gc.collect()

        art_name = artifact_for_mode(mode)
        if args.update_artifacts and art_name:
            art = Path(__file__).resolve().parent.parent / art_name
            if art.exists():
                data = json.loads(art.read_text())
                data["quality_vs_bf16"] = rec
                art.write_text(json.dumps(data, indent=2))
                print(f"patched {art.name}", file=sys.stderr)

    # merge with previously recorded modes so a partial --modes run never
    # erases the other modes' fidelity records from the device artifact
    out = Path(os.environ.get("BENCH_OUT",
                              f"bench_results_{device_tag()}.json"))
    if out.exists():
        prior = json.loads(out.read_text()).get("quant_quality", {})
        results = {**prior, **results}
    write_results("quant_quality", results)


if __name__ == "__main__":
    main()
