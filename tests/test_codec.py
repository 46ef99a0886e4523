"""Codec tests: shapes, strict causality, pad-window equivalence, RVQ encoder.

These invariants are what make the streaming vocoder a single fixed-shape
executable (audio/vocoder.py) — the JAX analog of the reference's calibrated
sliding-window decode (model.py:737-826)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.models import codec as C


@pytest.fixture(scope="module")
def codec(tiny_cfg):
    params = C.init_params(jax.random.PRNGKey(0), tiny_cfg.codec, jnp.float32)
    return params, tiny_cfg.codec


def _codes(cfg, n, seed=1):
    return jax.random.randint(jax.random.PRNGKey(seed), (1, n, cfg.num_quantizers),
                              0, cfg.codebook_size)


def test_decode_shape_exact_upsample(codec):
    params, cfg = codec
    wav = C.decode(params, cfg, _codes(cfg, 12))
    assert wav.shape == (1, 12 * cfg.total_upsample)
    assert np.abs(np.asarray(wav)).max() <= 1.0


def test_strict_causality(codec):
    """Prefix frames decode identically regardless of what follows."""
    params, cfg = codec
    codes = _codes(cfg, 24)
    full = np.asarray(C.decode(params, cfg, codes))
    prefix = np.asarray(C.decode(params, cfg, codes[:, :16]))
    np.testing.assert_allclose(full[:, : 16 * cfg.total_upsample], prefix, atol=1e-5)


def _perturb_biases(params, eps=0.05):
    """Set every bias/offset leaf to a nonzero constant.

    Random init zeroes all biases, which would hide any padding scheme that
    is only exact for zero biases (the round-1 left-pad masking bug,
    models/codec.py history)."""
    def f(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name in ("b", "norm_b", "beta1", "beta2", "out_beta", "beta"):
            return leaf + eps
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)


def test_right_pad_equivalence_nonzero_biases(codec):
    """Right-padded decode == unpadded decode on the valid prefix, even with
    every bias nonzero (strict causality makes right-padding exact)."""
    params, cfg = codec
    params = _perturb_biases(params)
    codes = _codes(cfg, 10)
    plain = np.asarray(C.decode(params, cfg, codes))
    padded = jnp.concatenate([codes, jnp.zeros((1, 6, cfg.num_quantizers), jnp.int32)], 1)
    win = np.asarray(C.decode(params, cfg, padded))
    np.testing.assert_allclose(win[:, : 10 * cfg.total_upsample], plain, atol=1e-4)


def test_stream_decoder_exact_with_nonzero_biases(codec):
    """StreamDecoder (fixed right-padded window) matches full decode with
    perturbed biases — the end-to-end guard for the padding scheme."""
    from qwen3tts_tpu.audio.vocoder import Vocoder

    params, cfg = codec
    params = _perturb_biases(params)
    v = Vocoder(params, cfg, context_frames=25)
    codes = np.asarray(_codes(cfg, 18)[0])
    full = v.decode(codes)
    sd = v.stream_decoder(chunk_size=6)
    outs = [sd.feed(codes[i : i + 6]) for i in range(0, 18, 6)]
    stream = np.concatenate(outs)
    assert stream.shape == full.shape
    np.testing.assert_allclose(outs[0], full[: len(outs[0])], atol=1e-5)


def test_bf16_vocoder_close_to_f32_and_stream_exact(codec):
    """bf16 compute (the default; matches the reference's bf16 speech
    tokenizer) stays close to f32 on the waveform, and streaming remains
    self-consistent (causality is dtype-independent)."""
    import jax.numpy as jnp

    from qwen3tts_tpu.audio.vocoder import Vocoder

    params, cfg = codec
    v32 = Vocoder(params, cfg, compute_dtype=jnp.float32)
    v16 = Vocoder(params, cfg, compute_dtype=jnp.bfloat16)
    codes = np.asarray(_codes(cfg, 20)[0])
    w32, w16 = v32.decode(codes), v16.decode(codes)
    assert w32.shape == w16.shape
    assert np.max(np.abs(w32 - w16)) < 0.05  # on [-1,1] audio

    sd = v16.stream_decoder(chunk_size=5)
    stream = np.concatenate([sd.feed(codes[i : i + 5]) for i in range(0, 20, 5)])
    assert stream.shape == w16.shape
    np.testing.assert_allclose(stream[: 5 * cfg.total_upsample],
                               w16[: 5 * cfg.total_upsample], atol=1e-5)


def test_encode_shapes_and_range(codec):
    params, cfg = codec
    wav = jax.random.normal(jax.random.PRNGKey(2), (1, 10 * cfg.total_upsample)) * 0.1
    codes = C.encode(params, cfg, wav)
    assert codes.shape == (1, 10, cfg.num_quantizers)
    assert int(codes.min()) >= 0 and int(codes.max()) < cfg.codebook_size


def test_encode_drops_partial_frame(codec):
    params, cfg = codec
    wav = jnp.zeros((1, 3 * cfg.total_upsample + 17))
    assert C.encode(params, cfg, wav).shape[1] == 3


def test_vocoder_stream_matches_full_decode(codec):
    """StreamDecoder with context >= receptive window matches chunk count and
    length; and context-window output is identical to full decode for the
    frames where full left context is present."""
    from qwen3tts_tpu.audio.vocoder import Vocoder

    params, cfg = codec
    v = Vocoder(params, cfg, context_frames=25)
    codes = np.asarray(_codes(cfg, 30)[0])
    full = v.decode(codes)
    sd = v.stream_decoder(chunk_size=6)
    outs = [sd.feed(codes[i : i + 6]) for i in range(0, 30, 6)]
    stream = np.concatenate(outs)
    assert stream.shape == full.shape
    # first (context) chunk is exactly the full decode prefix
    np.testing.assert_allclose(outs[0], full[: len(outs[0])], atol=1e-5)


def test_stream_decoder_icl_priming(codec):
    """Priming with reference codes (ICL) gives later chunks real left
    context — the feed after priming must differ from an unprimed feed and
    return only the new frames' samples."""
    import numpy as np

    from qwen3tts_tpu.audio.vocoder import Vocoder

    params, cfg = codec
    v = Vocoder(params, cfg, context_frames=25)
    ref = np.asarray(_codes(cfg, 10, seed=5)[0])
    gen = np.asarray(_codes(cfg, 6, seed=6)[0])

    primed = v.stream_decoder(chunk_size=6)
    primed.feed(ref)  # discard ref audio
    out_primed = primed.feed(gen)

    unprimed = v.stream_decoder(chunk_size=6)
    out_unprimed = unprimed.feed(gen)

    assert out_primed.shape == out_unprimed.shape == (6 * cfg.total_upsample,)
    assert not np.allclose(out_primed, out_unprimed)  # context changed output

    # primed output must equal the suffix of a full decode of ref+gen
    full = v.decode(np.concatenate([ref, gen]))
    np.testing.assert_allclose(out_primed, full[10 * cfg.total_upsample :], atol=1e-4)


def test_batched_stream_state_staggered_rows(codec):
    """ONE batched stream state serving rows that joined at different times
    (per-row ``frame0``) must emit each row's audio exactly as an
    independent single-row streaming decode — the invariant behind the
    continuous batcher's fused batched vocode (runtime/scheduler.py)."""
    from qwen3tts_tpu.audio.vocoder import Vocoder

    params, cfg = codec
    v = Vocoder(params, cfg, compute_dtype=None)
    spf = cfg.total_upsample
    B, chunk = 3, 4

    row_codes = [np.asarray(_codes(cfg, 16, seed=10 + b)[0]) for b in range(B)]
    ref = np.asarray(_codes(cfg, 7, seed=99)[0])  # row 2 is ICL-primed

    st = v.stream_state_batched(B)
    # rows 0 and 1 active from the start; row 1 replaced mid-stream
    st = v.scatter_stream_row(st, v.stream_state(), 0)
    st = v.scatter_stream_row(st, v.stream_state(), 1)

    audio = {0: [], 1: [], 2: []}
    owner = {0: 0, 1: 1}  # batch row -> logical stream (row 2 stays garbage)
    fed = {0: 0, 1: 0, 2: 0}
    for boundary in range(6):
        if boundary == 2:  # stream 1 retires; a primed stream 2 takes row 1
            primed = v.stream_state()
            _, primed = v.stream_feed(primed, ref, collect_audio=False)
            st = v.scatter_stream_row(st, primed, 1)
            owner[1] = 2
        # retired/unused rows feed zeros — the garbage churn a retired
        # serving row sees between admissions
        batch = np.zeros((B, chunk, cfg.num_quantizers), np.int32)
        live = {r: s for r, s in owner.items() if fed[s] + chunk <= 16}
        for r, s in live.items():
            batch[r] = row_codes[s][fed[s]: fed[s] + chunk]
        wav, st = v._stream_step_jit(v.params, state=st,
                                     codes=jnp.asarray(batch))
        wav = np.asarray(wav)
        for r, s in live.items():
            audio[s].append(wav[r])
            fed[s] += chunk

    # row 0: uninterrupted stream == single-row stateful decode
    sd = v.stateful_stream_decoder()
    expect0 = sd.feed(row_codes[0][:16])
    np.testing.assert_allclose(np.concatenate(audio[0])[: len(expect0)],
                               expect0, atol=1e-5)
    # row 2 (joined mid-batch, ICL-primed): equals the suffix of a full
    # decode of ref+its codes — exact despite sharing state with other rows
    got2 = np.concatenate(audio[2])
    full2 = v.decode(np.concatenate([ref, row_codes[2][: len(got2) // spf]]))
    np.testing.assert_allclose(got2, full2[7 * spf:], atol=1e-4)
