"""Flash-decode kernel (Pallas, Triton route) vs the plain float32 oracle,
run through the Pallas interpreter on CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.ops.flash_decode import flash_decode, flash_decode_reference


@pytest.mark.parametrize("pos,pad", [(0, 0), (7, 0), (130, 5), (255, 31)])
def test_matches_oracle(pos, pad):
    S, KVH, D, NH = 256, 2, 32, 4
    q = jax.random.normal(jax.random.PRNGKey(0), (NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (S, KVH, D), jnp.float32)
    out = flash_decode(q, k, v, jnp.int32(pos), jnp.int32(pad),
                       block_k=64, interpret=True)
    ref = flash_decode_reference(q, k, v, pos, pad)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_sliding_window():
    S, KVH, D, NH = 256, 2, 32, 4
    q = jax.random.normal(jax.random.PRNGKey(0), (NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (S, KVH, D), jnp.float32)
    out = flash_decode(q, k, v, jnp.int32(200), jnp.int32(0),
                       block_k=64, sliding_window=48, interpret=True)
    ref = flash_decode_reference(q, k, v, 200, 0, sliding_window=48)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_dynamic_trip_count_independent_of_tail():
    """Garbage beyond pos must not affect the result (only the live prefix
    is ever read)."""
    S, KVH, D, NH = 256, 2, 32, 4
    q = jax.random.normal(jax.random.PRNGKey(0), (NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (S, KVH, D), jnp.float32)
    k_dirty = k.at[100:].set(jnp.nan)
    v_dirty = v.at[100:].set(jnp.inf)
    out = flash_decode(q, k_dirty, v_dirty, jnp.int32(63), jnp.int32(0),
                       block_k=64, interpret=True)
    ref = flash_decode_reference(q, k, v, 63, 0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_batched_rows_match_per_row_oracle():
    import jax

    from qwen3tts_tpu.ops.flash_decode import flash_decode_batched

    B, S, KVH, G, D = 3, 256, 2, 4, 64
    NH = KVH * G
    q = jax.random.normal(jax.random.PRNGKey(0), (B, NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, S, KVH, D), jnp.float32)
    pos = 120
    pads = jnp.asarray([0, 37, 100], jnp.int32)  # incl. a joined-row-style pad
    out = flash_decode_batched(q, k, v, jnp.int32(pos), pads, block_k=64,
                               interpret=True)
    for b in range(B):
        ref = flash_decode_reference(q[b], k[b], v[b], pos, int(pads[b]))
        np.testing.assert_allclose(np.asarray(out[b]), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_batched_fully_padded_row_is_finite():
    import jax

    from qwen3tts_tpu.ops.flash_decode import flash_decode_batched

    B, S, KVH, G, D = 2, 128, 2, 2, 64
    NH = KVH * G
    q = jax.random.normal(jax.random.PRNGKey(0), (B, NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, S, KVH, D), jnp.float32)
    # row 1 has pad > pos: zero live slots — its lane must not NaN
    out = flash_decode_batched(q, k, v, jnp.int32(10), jnp.asarray([0, 64]),
                               block_k=64, interpret=True)
    assert np.isfinite(np.asarray(out)).all()


def test_pad_beyond_pos_row_is_zero_and_starts_no_dma():
    """A row whose pad exceeds pos has no live tile: every split of it is
    empty, its output is exactly zero, and the live rows stay correct (a
    mis-joined batch row must not poison the batch)."""
    from qwen3tts_tpu.ops.flash_decode import (flash_decode_batched,
                                               flash_decode_reference)

    B, S, KVH, G, D = 3, 256, 2, 2, 64
    NH = KVH * G
    q = jax.random.normal(jax.random.PRNGKey(0), (B, NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, S, KVH, D), jnp.float32)
    pos, pads = 33, [0, 200, 5]  # row 1 mis-joined: pad 200 > pos 33
    out = np.asarray(flash_decode_batched(
        q, k, v, jnp.int32(pos), jnp.asarray(pads), block_k=64,
        interpret=True))
    assert np.allclose(out[1], 0.0)
    for b in (0, 2):
        ref = flash_decode_reference(q[b], k[b], v[b], pos, pads[b])
        np.testing.assert_allclose(out[b], np.asarray(ref), atol=1e-5)


def test_mixed_sliding_stack_flash_matches_masked():
    """Mixed ``layer_types`` stack (upstream Qwen3 carries sliding_attention
    layers; reference talker_graph.py:76, predictor_graph.py:96-104): the
    flash path conds per layer between a windowed and a full kernel variant
    (models/layers.py block_forward) — it must match the masked-XLA path
    exactly, and the sliding layers must actually bite."""
    from qwen3tts_tpu.core.config import TalkerConfig
    from qwen3tts_tpu.models import talker as T

    def mk(layer_types):
        return TalkerConfig(
            hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128,
            mrope_section=(4, 2, 2), vocab_size=256, text_vocab_size=64,
            text_hidden_size=64, speaker_embed_dim=64,
            sliding_window=8, layer_types=layer_types,
        )

    cfg = mk(("full_attention", "sliding_attention") * 2)
    params = T.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    H = cfg.hidden_size
    embeds = jax.random.normal(jax.random.PRNGKey(1), (2, 12, H), jnp.float32) * 0.1
    pad = jnp.asarray([0, 3], jnp.int32)

    def run(cfg, use_flash):
        kv = T.new_kv_cache(cfg, batch=2, max_len=32, dtype=jnp.float32)
        _, _, kv = T.prefill(params, cfg, embeds, pad, kv)
        x = jax.random.normal(jax.random.PRNGKey(2), (2, 1, H), jnp.float32) * 0.1
        outs = []
        for pos in (12, 13):  # past the window for row 0 (eff pos > 8)
            x2, kv = T.decode_step(params, cfg, x, jnp.int32(pos), pad, kv,
                                   use_flash=use_flash, interpret=True)
            outs.append(np.asarray(x2))
        return np.stack(outs)

    out_flash = run(cfg, True)
    out_masked = run(cfg, False)
    np.testing.assert_allclose(out_flash, out_masked, rtol=1e-5, atol=1e-5)

    # guard against a vacuous pass: an all-full stack must give a DIFFERENT
    # answer at these positions (the window is genuinely active)
    out_allfull = run(mk(("full_attention",) * 4), True)
    assert not np.allclose(out_flash, out_allfull, atol=1e-5)


def test_kernel_refuses_cpu_without_interpret():
    """No hidden fallback: compiled for the GPU only, the kernel raises on
    another backend unless the caller asks for the interpreter."""
    q = jnp.zeros((4, 32), jnp.float32)
    kv = jnp.zeros((64, 2, 32), jnp.float32)
    with pytest.raises(ValueError, match="interpret=True"):
        flash_decode(q, kv, kv, jnp.int32(3), jnp.int32(0))


def test_engine_attention_choice_on_cpu(tiny_cfg, tiny_models):
    """The CPU reads attention through the masked XLA path; forcing the
    kernel there is an explicit error, not a silent interpreter run."""
    from qwen3tts_tpu.runtime.engine import Engine, flash_decode_default

    tp, pp = tiny_models
    assert not flash_decode_default(tiny_cfg.talker)
    assert not Engine(tp, pp, tiny_cfg, max_seq_len=64).use_flash_decode
    with pytest.raises(ValueError, match="needs a GPU"):
        Engine(tp, pp, tiny_cfg, max_seq_len=64, use_flash_decode=True)


@pytest.mark.parametrize("batch,kvh,want", [(1, 8, 16), (8, 8, 4), (24, 8, 1),
                                            (64, 8, 1), (1, 2, 16)])
def test_default_k_splits(batch, kvh, want):
    """Split count targets ~2 waves of blocks on 132 SMs, power of two."""
    from qwen3tts_tpu.ops.flash_decode import default_k_splits

    assert default_k_splits(batch, kvh) == want


@pytest.mark.parametrize("k_splits", [1, 3, 8])
def test_split_count_does_not_change_the_result(k_splits):
    B, S, KVH, G, D = 2, 256, 2, 2, 32
    q = jax.random.normal(jax.random.PRNGKey(0), (B, KVH * G, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, S, KVH, D), jnp.float32)
    pos, pads = 200, [0, 90]
    from qwen3tts_tpu.ops.flash_decode import flash_decode_batched

    out = flash_decode_batched(q, k, v, jnp.int32(pos), jnp.asarray(pads),
                               block_k=32, k_splits=k_splits, interpret=True)
    for b in range(B):
        ref = flash_decode_reference(q[b], k[b], v[b], pos, pads[b])
        np.testing.assert_allclose(np.asarray(out[b]), np.asarray(ref),
                                   atol=1e-5)


@pytest.mark.parametrize("pos,pads,window", [
    (0, [0, 0], None), (350, [0, 100], None), (511, [7, 300], None),
    (400, [0, 50], 128)])
def test_masked_path_matches_reference_at_talker_geometry(pos, pads, window):
    """The masked XLA attention (models/layers.py, what the CPU and any
    non-kernel engine run) against the f32 oracle at the 0.6B talker's head
    geometry: NH 16, KVH 8, D 128 (cache cut to 512 slots for the CPU)."""
    from qwen3tts_tpu.models.layers import _attn_core, decode_mask

    B, S, NH, KVH, D = len(pads), 512, 16, 8, 128
    q = jax.random.normal(jax.random.PRNGKey(3), (B, 1, NH, D), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(4), (B, S, KVH, D), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(5), (B, S, KVH, D), jnp.float32)
    mask = decode_mask(S, jnp.int32(pos), jnp.asarray(pads, jnp.int32), window)
    with jax.default_matmul_precision("highest"):
        out = _attn_core(q, k, v, mask, NH // KVH)
        for b in range(B):
            ref = flash_decode_reference(q[b, 0], k[b], v[b], pos, pads[b],
                                         sliding_window=window)
            np.testing.assert_allclose(np.asarray(out[b, 0]), np.asarray(ref),
                                       atol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu():
    """The kernel as compiled for the card, at the talker's real widths
    (chip_smoke.py runs the same check on the card)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernel has no CPU "
                    "compile; `python chip_smoke.py` runs this on the card")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    worst = chip_smoke.check_kernel_parity(jax, jnp)
    assert worst["float32"] <= chip_smoke.F32_TOL
    assert worst["bfloat16"] <= chip_smoke.BF16_TOL
