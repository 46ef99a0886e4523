"""Quantization quality gate + fidelity-metric units.

The int8 speed headlines need a fidelity axis; these tests pin the metric
machinery and assert floors on the tiny preset so a quantization regression
(e.g. a broken scale layout silently zeroing weights) fails loudly.  All
values are deterministic: same weights (seed 0), same fixed PRNG key.
"""
import numpy as np
import pytest

from qwen3tts_tpu.utils.quality import (
    log_mel, log_mel_distance, mel_filterbank, quant_quality, token_agreement,
    waveform_snr_db)


# ---------------------------------------------------------------------------
# metric units
# ---------------------------------------------------------------------------


def test_snr_identical_caps():
    x = np.sin(np.linspace(0, 20, 4800)).astype(np.float32)
    assert waveform_snr_db(x, x) == 99.0


def test_snr_known_value():
    rs = np.random.RandomState(0)
    x = rs.randn(48000)
    noise = rs.randn(48000) * 0.1
    snr = waveform_snr_db(x, x + noise)
    # power ratio 1 / 0.01 = 20 dB
    assert 19.0 < snr < 21.0


def test_snr_length_mismatch_truncates():
    x = np.ones(1000)
    assert waveform_snr_db(x, x[:500]) == 99.0
    assert waveform_snr_db(np.zeros(0), x) == 0.0


def test_mel_filterbank_shape_and_coverage():
    fb = mel_filterbank(24_000, 1024, 80)
    assert fb.shape == (80, 513)
    assert (fb >= 0).all()
    # every filter has some support
    assert (fb.sum(axis=1) > 0).all()


def test_log_mel_shapes_and_distance():
    sr = 24_000
    t = np.linspace(0, 1, sr, dtype=np.float32)
    a = np.sin(2 * np.pi * 220 * t)
    b = np.sin(2 * np.pi * 440 * t)
    la = log_mel(a, sr)
    assert la.shape[1] == 80 and la.shape[0] > 80
    assert log_mel_distance(a, a, sr) == 0.0
    assert log_mel_distance(a, b, sr) > 0.1  # different pitch is visible


def test_token_agreement_stats():
    a = np.zeros((10, 16), np.int32)
    b = a.copy()
    b[7:, 0] = 5
    r = token_agreement(a, b)
    assert r["first_divergence_step"] == 7
    assert r["cb0_match_rate"] == 0.7
    assert r["steps_compared"] == 10
    full = token_agreement(a, a)
    assert full["match_rate"] == 1.0 and full["first_divergence_step"] == 10


# ---------------------------------------------------------------------------
# the gate: tiny preset, bf16 vs quantized modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_tiny():
    from qwen3tts_tpu import FasterQwen3TTS

    return FasterQwen3TTS.from_pretrained("random:tiny")


@pytest.mark.parametrize("mode,kw,floors", [
    # Free-running metrics (match_rate, log_mel, SNR) report DIVERGENCE:
    # with random weights argmax margins are razor-thin, one flip makes the
    # rest incomparable — their floors only assert the sane band.  The
    # teacher-forced metrics are the FIDELITY claim: with identical token
    # history, int8's per-step perturbation flips only a small fraction of
    # argmaxes (max_tf_flips), and the unquantized vocoder on identical
    # codes is bit-exact.
    ("int8", {"quantize": "int8"},
     dict(min_match=0.02, max_logmel=2.0, min_snr=-15.0, max_tf_flips=0.25)),
    ("w8a8", {"quantize": "w8a8"},
     dict(min_match=0.02, max_logmel=2.0, min_snr=-15.0, max_tf_flips=0.25)),
    # the int8 KV cache's smaller perturbation still flips razor-thin
    # random-weight argmaxes (text-dependent), so it gets the same band
    ("kv_quant", {"kv_quant": True},
     dict(min_match=0.02, max_logmel=2.0, min_snr=-15.0, max_tf_flips=0.25)),
])
@pytest.mark.slow
def test_quant_quality_floor(bf16_tiny, ref_wav, mode, kw, floors):
    from qwen3tts_tpu import FasterQwen3TTS

    q = FasterQwen3TTS.from_pretrained("random:tiny", **kw)
    r = quant_quality(bf16_tiny, q, text="hello quality gate", ref_audio=ref_wav,
                      ref_text="ref", steps=24)
    assert r["steps_compared"] == 24, r
    assert r["match_rate"] >= floors["min_match"], (mode, r)
    assert r["log_mel_dist"] <= floors["max_logmel"], (mode, r)
    assert r["waveform_snr_db"] >= floors["min_snr"], (mode, r)
    tf = r["teacher_forced"]
    assert tf["argmax_flip_rate"] <= floors["max_tf_flips"], (mode, tf)
    assert tf["logit_mse"] < 1.0, (mode, tf)
    if "quantize" in kw:
        # the vocoder is never quantized — identical codes must round-trip
        # bit-exactly, proving fidelity loss can only enter via tokens
        assert tf["vocoder_snr_db"] == 99.0, (mode, tf)


def test_quant_quality_self_is_perfect(bf16_tiny, ref_wav):
    """Same model on both sides → bit-identical generation (the fixed PRNG
    key really does pin the sampled codebooks) AND exactly-zero teacher-
    forced deltas (the measurement path itself adds no noise)."""
    r = quant_quality(bf16_tiny, bf16_tiny, text="identity check",
                      ref_audio=ref_wav, ref_text="ref", steps=12)
    assert r["match_rate"] == 1.0
    assert r["waveform_snr_db"] == 99.0
    assert r["log_mel_dist"] == 0.0
    tf = r["teacher_forced"]
    assert tf["logit_mse"] == 0.0 and tf["argmax_flip_rate"] == 0.0
    assert tf["vocoder_snr_db"] == 99.0


def test_teacher_forced_covers_all_frames(bf16_tiny, ref_wav):
    """Shape contract: talker logits align 1:1 with codes[:, 0] (prefill
    predicts frame 0) and predictor logits cover all 15 codebooks of every
    frame."""
    from qwen3tts_tpu.utils.quality import (fixed_generation,
                                            teacher_forced_logits)

    ids, _ = fixed_generation(bf16_tiny, "shapes", ref_wav, "ref", "English",
                              8, 3)
    tl, pl = teacher_forced_logits(bf16_tiny, "shapes", ref_wav, "ref",
                                   "English", ids)
    V = bf16_tiny.cfg.talker.vocab_size
    CB = bf16_tiny.cfg.predictor.codebook_size
    assert tl.shape == (8, V)
    assert pl.shape == (8, 15, CB)
    # alignment/causality: perturbing the teacher's cb0 at frame k must leave
    # talker logits 0..k and predictor frames 0..k-1 bit-identical (they see
    # only earlier history), and must change the predictor at frame k (it
    # conditions on the frame's cb0) and the talker at k+1
    k = 4
    ids2 = np.array(ids)
    ids2[k, 0] = (ids2[k, 0] + 1) % V
    tl2, pl2 = teacher_forced_logits(bf16_tiny, "shapes", ref_wav, "ref",
                                     "English", ids2)
    np.testing.assert_array_equal(tl2[: k + 1], tl[: k + 1])
    np.testing.assert_array_equal(pl2[:k], pl[:k])
    assert not np.array_equal(pl2[k], pl[k])
    assert not np.array_equal(tl2[k + 1], tl[k + 1])
