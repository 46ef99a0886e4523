"""Audio-fidelity metrics + the int8 quantization quality gate.

The int8 / w8a8 / kv_quant headline numbers were speed-only; this module
makes their quality cost measurable TODAY with
random weights and re-runnable the day real weights land:

  - ``waveform_snr_db`` / ``log_mel_distance`` — fidelity of the quantized
    model's audio against the bf16 model's audio at identical seeds;
  - ``token_agreement`` — how much quantization perturbs the decode
    decisions themselves (exact-match rate over the [steps, 16] codec ids,
    plus the first step where codebook-0 diverges);
  - ``quant_quality`` — the full A/B: two models, same weights/seed/PRNG
    stream, greedy codebook-0, fixed generation length.

The reference handles audio-quality regression with committed sample WAVs +
seeds rather than assertions (samples/parity/README.md); this adds a numeric
proxy on top so the bench artifacts carry a ``quality_vs_bf16`` record
(benchmarks/quant_quality.py) and tests can assert a floor.

Everything is pure numpy on host — no device work beyond the generations.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_SNR_CAP_DB = 99.0


def waveform_snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against ``ref`` (dB), truncated to the common length.
    Identical signals cap at 99 dB."""
    ref = np.asarray(ref, np.float64).ravel()
    test = np.asarray(test, np.float64).ravel()
    n = min(len(ref), len(test))
    if n == 0:
        return 0.0
    ref, test = ref[:n], test[:n]
    sig = float(np.sum(ref * ref))
    err = float(np.sum((ref - test) ** 2))
    if err <= sig * 10 ** (-_SNR_CAP_DB / 10):
        return _SNR_CAP_DB
    if sig == 0.0:
        return 0.0
    return float(10.0 * np.log10(sig / err))


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK-mel filterbank."""
    fmax = fmax or sr / 2
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for b in range(lo, ctr):
            if ctr > lo:
                fb[i, b] = (b - lo) / (ctr - lo)
        for b in range(ctr, hi):
            if hi > ctr:
                fb[i, b] = (hi - b) / (hi - ctr)
    return fb


def log_mel(wav: np.ndarray, sr: int = 24_000, n_fft: int = 1024,
            hop: int = 256, n_mels: int = 80) -> np.ndarray:
    """[frames, n_mels] log-mel spectrogram (numpy STFT, Hann window)."""
    wav = np.asarray(wav, np.float64).ravel()
    if len(wav) < n_fft:
        wav = np.pad(wav, (0, n_fft - len(wav)))
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(sr, n_fft, n_mels).T
    return np.log(np.maximum(mel, 1e-10))


def log_mel_distance(ref: np.ndarray, test: np.ndarray,
                     sr: int = 24_000) -> float:
    """Mean absolute log-mel difference over the common frame count — the
    standard "does it sound the same" proxy (robust to phase, unlike SNR)."""
    a, b = log_mel(ref, sr), log_mel(test, sr)
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.mean(np.abs(a[:n] - b[:n])))


def token_agreement(ids_a: np.ndarray, ids_b: np.ndarray) -> Dict[str, float]:
    """Exact-match stats between two [steps, 16] codec-id matrices."""
    a, b = np.asarray(ids_a), np.asarray(ids_b)
    n = min(len(a), len(b))
    if n == 0:
        return {"match_rate": 0.0, "cb0_match_rate": 0.0,
                "first_divergence_step": 0, "steps_compared": 0}
    a, b = a[:n], b[:n]
    cb0_neq = np.nonzero(a[:, 0] != b[:, 0])[0]
    return {
        "match_rate": float(np.mean(a == b)),
        "cb0_match_rate": float(np.mean(a[:, 0] == b[:, 0])),
        "first_divergence_step": int(cb0_neq[0]) if len(cb0_neq) else n,
        "steps_compared": n,
    }


def fixed_generation(model, text, ref_audio, ref_text, language, steps, seed):
    """Greedy-codebook-0, fixed-length generation returning (ids, audio).
    A FIXED PRNG key (not the model's stream) keeps the predictor's sampled
    codebooks comparable across the two models."""
    import jax

    from ..runtime import loops

    embeds, trailing, tpe, ref_codes = model._prepare_clone(
        text, ref_audio, ref_text, language, True, True, True, None)
    # min == max: EOS suppressed throughout, so both runs emit exactly
    # ``steps`` frames and every metric is length-aligned
    pol, ppol = model._policies(
        temperature=0.9, top_k=50, top_p=1.0, do_sample=False,
        repetition_penalty=1.05, min_new_tokens=steps)
    model._warmup(embeds.shape[1], trailing.shape[1], pol, ppol)
    ids, timing = loops.fast_generate(
        model.engine, embeds, trailing, tpe, key=jax.random.PRNGKey(seed),
        max_new_tokens=steps, policy=pol, pred_policy=ppol)
    ids = np.asarray(ids)
    audio = np.asarray(model.vocoder.decode(ids))
    return ids, audio


def teacher_forced_logits(model, text, ref_audio, ref_text, language,
                          codes: np.ndarray):
    """Run the model's talker+predictor over a FIXED token history.

    ``codes`` is a [steps, 16] codec-id matrix (codebook 0 = talker token,
    1..15 = predictor).  Every step's inputs come from the teacher codes, so
    two models given the same codes see bit-identical histories — their
    per-step logit deltas isolate model noise (e.g. quantization) from the
    compounding divergence a free-running comparison suffers after the first
    argmax flip.

    Returns (talker_logits [steps, V], pred_logits [steps, 15, CB]) where
    ``talker_logits[t]`` is the raw codec-head output whose argmax is the
    model's prediction for ``codes[t, 0]`` (t=0 comes from the prefill), and
    ``pred_logits[t, i]`` predicts ``codes[t, i+1]``."""
    import jax
    import jax.numpy as jnp

    from ..models import predictor as predictor_lib
    from ..models import talker as talker_lib

    embeds, trailing, tpe, _ = model._prepare_clone(
        text, ref_audio, ref_text, language, True, True, True, None)
    tcfg, pcfg = model.cfg.talker, model.cfg.predictor
    eng = model.engine
    steps = int(codes.shape[0])
    T = int(embeds.shape[1])
    Tt = int(trailing.shape[1])

    def impl(tparams, pparams, embeds, trailing, tpe, codes):
        zero_pad = jnp.zeros((1,), jnp.int32)
        kv = talker_lib.new_kv_cache(tcfg, 1, T + steps + 1, eng.dtype,
                                     kv_quant=eng.kv_quant)
        last, logits_p, kv = talker_lib.prefill(
            tparams, tcfg, embeds, zero_pad, kv)

        def body(carry, frame):  # frame: [16] int32
            kv, past_hidden, pos, gen_step = carry
            token = frame[:1]
            tok_embed = talker_lib.embed_codec(tparams, token)[:, None, :]
            pred_input = jnp.concatenate([past_hidden, tok_embed], axis=1)
            pred_logits = predictor_lib.predict_frame_teacher(
                pparams, pcfg, pred_input, frame[None, 1:])
            emb_sum = predictor_lib.embed_sum_for(
                pparams, pcfg, frame[None, 1:], tok_embed.dtype)
            trail = jnp.where(gen_step < Tt,
                              jax.lax.dynamic_index_in_dim(
                                  trailing, jnp.minimum(gen_step, Tt - 1),
                                  axis=1),
                              tpe)
            x = tok_embed + emb_sum.astype(tok_embed.dtype) + trail
            hidden, kv = talker_lib.decode_step(
                tparams, tcfg, x, pos, zero_pad, kv, use_flash=False)
            logits = talker_lib.codec_head(tparams, hidden[:, 0, :])
            return ((kv, hidden, pos + 1, gen_step + 1),
                    (logits[0], pred_logits[0]))

        carry0 = (kv, last, jnp.int32(T), jnp.int32(0))
        _, (tl, pl) = jax.lax.scan(body, carry0, codes)
        # talker logits aligned with codes[:, 0]: prefill predicts frame 0,
        # step t predicts frame t+1 (the last step's output predicts a frame
        # beyond the teacher sequence — dropped)
        talker_logits = jnp.concatenate([logits_p, tl[:-1]], axis=0)
        return talker_logits, pl

    tl, pl = jax.jit(impl)(
        eng.talker_params, eng.predictor_params,
        jnp.asarray(embeds, eng.dtype), jnp.asarray(trailing, eng.dtype),
        jnp.asarray(tpe, eng.dtype), jnp.asarray(codes, jnp.int32))
    return np.asarray(tl, np.float32), np.asarray(pl, np.float32)


def teacher_forced_quality(model_ref, model_q, *, text: str, ref_audio,
                           ref_text: str, language: str = "English",
                           codes: np.ndarray) -> Dict:
    """Token-matched fidelity of ``model_q`` against ``model_ref`` over the
    SAME code history (teacher forcing): per-step logit MSE and argmax-flip
    rate for the talker and predictor heads separately, plus vocoder waveform
    SNR on identical codes.  These numbers measure quantization noise
    directly — unlike free-running divergence, one flipped token cannot
    cascade."""
    tl_r, pl_r = teacher_forced_logits(
        model_ref, text, ref_audio, ref_text, language, codes)
    tl_q, pl_q = teacher_forced_logits(
        model_q, text, ref_audio, ref_text, language, codes)
    wav_r = np.asarray(model_ref.vocoder.decode(codes))
    wav_q = np.asarray(model_q.vocoder.decode(codes))
    talker_mse = float(np.mean((tl_r - tl_q) ** 2))
    pred_mse = float(np.mean((pl_r - pl_q) ** 2))
    talker_flips = float(np.mean(tl_r.argmax(-1) != tl_q.argmax(-1)))
    pred_flips = float(np.mean(pl_r.argmax(-1) != pl_q.argmax(-1)))
    return {
        "steps": int(codes.shape[0]),
        # headline aggregates (both heads pooled)
        "logit_mse": round((talker_mse + pred_mse) / 2, 6),
        "argmax_flip_rate": round(
            float(np.mean(np.concatenate([
                (tl_r.argmax(-1) != tl_q.argmax(-1)).ravel(),
                (pl_r.argmax(-1) != pl_q.argmax(-1)).ravel()]))), 4),
        "vocoder_snr_db": round(waveform_snr_db(wav_r, wav_q), 2),
        # per-component split
        "talker_logit_mse": round(talker_mse, 6),
        "talker_argmax_flip_rate": round(talker_flips, 4),
        "pred_logit_mse": round(pred_mse, 6),
        "pred_argmax_flip_rate": round(pred_flips, 4),
    }


def quant_quality(model_ref, model_q, *, text: str, ref_audio, ref_text: str,
                  language: str = "English", steps: int = 48,
                  seed: int = 1337, teacher_forced: bool = True) -> Dict:
    """A/B fidelity of ``model_q`` against ``model_ref`` (same weights/seed,
    e.g. bf16 vs int8).

    Two layers:
      - ``teacher_forced`` (primary): both models over the reference model's
        code history — logit MSE, argmax-flip rates, vocoder SNR on identical
        codes.  This is the fidelity claim.
      - free-running (secondary): token agreement + waveform SNR + log-mel
        distance of each model's OWN generation at the same seed.  After the
        first argmax flip the sequences are incomparable, so these report
        divergence, not quality.

    Returns a JSON-ready dict for the ``quality_vs_bf16`` bench field."""
    ids_r, wav_r = fixed_generation(
        model_ref, text, ref_audio, ref_text, language, steps, seed)
    ids_q, wav_q = fixed_generation(
        model_q, text, ref_audio, ref_text, language, steps, seed)
    out = {
        "steps": int(steps),
        "waveform_snr_db": round(waveform_snr_db(wav_r, wav_q), 2),
        "log_mel_dist": round(log_mel_distance(wav_r, wav_q,
                                               model_ref.sample_rate), 4),
    }
    out.update(token_agreement(ids_r, ids_q))
    if teacher_forced:
        out["teacher_forced"] = teacher_forced_quality(
            model_ref, model_q, text=text, ref_audio=ref_audio,
            ref_text=ref_text, language=language, codes=ids_r)
    return out
