"""Real-checkpoint loop: upstream torch-layout checkpoints end-to-end.

Synthesizes a fake upstream checkpoint directory (torch tensor names,
[out,in]/[Cout,Cin,K] layouts, multi-file shards + index.json, HF-style
config.json, tokenizer.json) and proves ``from_pretrained`` on it produces
the same model as the canonical format — the zero-egress analog of loading
the published Qwen3-TTS weights (reference model.py:71-152).
"""
import json

import jax
import numpy as np
import pytest

from qwen3tts_tpu.core import loader
from qwen3tts_tpu.core.config import TTSModelConfig, normalize_model_size


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One tiny model written in BOTH formats (canonical + sharded torch)."""
    from qwen3tts_tpu import FasterQwen3TTS

    m = FasterQwen3TTS.from_pretrained("random:tiny")
    host = jax.tree.map(np.asarray, m.params)
    root = tmp_path_factory.mktemp("ckpts")
    canon = root / "canonical"
    torch_dir = root / "torch_layout"
    m.save_pretrained(canon)
    loader.export_torch_checkpoint(torch_dir, m.cfg, host, num_shards=3)
    return m.cfg, host, canon, torch_dir


def _flat_allclose(a, b):
    fa, fb = loader.flatten(a), loader.flatten(b)
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        np.testing.assert_allclose(
            np.asarray(fa[k], np.float32), np.asarray(fb[k], np.float32),
            err_msg=k, atol=0)


def test_torch_dir_layout(bundles):
    """The synthesized dir has the upstream shape: HF config keys, shards,
    index.json, torch names."""
    _, _, _, torch_dir = bundles
    raw = json.loads((torch_dir / "config.json").read_text())
    assert "talker_config" in raw and "talker" not in raw
    shards = sorted(p.name for p in torch_dir.glob("model-*-of-*.safetensors"))
    assert len(shards) == 3
    index = json.loads((torch_dir / "model.safetensors.index.json").read_text())
    names = set(index["weight_map"])
    assert any(n.startswith("talker.model.layers.0.self_attn.q_proj") for n in names)
    assert any(n.startswith("speech_tokenizer.") for n in names)
    assert any(n.startswith("speaker_encoder.") for n in names)
    assert any(n.startswith("talker.code_predictor.lm_head.") for n in names)


def test_torch_load_equals_canonical_load(bundles):
    """load_checkpoint(torch dir) == load_checkpoint(canonical dir), leafwise."""
    _, _, canon, torch_dir = bundles
    cfg_a, a = loader.load_checkpoint(canon)
    cfg_b, b = loader.load_checkpoint(torch_dir)
    assert cfg_a.talker.hidden_size == cfg_b.talker.hidden_size
    assert cfg_a.model_type == cfg_b.model_type
    _flat_allclose(a, b)


@pytest.mark.slow
def test_from_pretrained_torch_dir_generates_same_tokens(bundles, ref_wav):
    """Full loop: from_pretrained on the torch dir → generate → audio equal
    to the canonical-format load of the same weights."""
    from qwen3tts_tpu import FasterQwen3TTS

    _, _, canon, torch_dir = bundles
    wavs = []
    for d in (canon, torch_dir):
        m = FasterQwen3TTS.from_pretrained(str(d), seed=3)
        audio, sr = m.generate_voice_clone(
            "hi", "english", ref_wav, "ref", max_new_tokens=12)
        wavs.append(np.asarray(audio[0]))
    assert wavs[0].shape == wavs[1].shape
    np.testing.assert_allclose(wavs[0], wavs[1], atol=0)


def test_missing_half_raises(bundles, tmp_path):
    """A checkpoint missing the codec or speaker tensors must fail loudly."""
    from safetensors.numpy import save_file

    cfg, host, _, _ = bundles
    named = loader.export_torch_layout(
        {"talker": host["talker"], "predictor": host["predictor"]}, cfg)
    d = tmp_path / "partial"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    save_file(named, str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="speech_tokenizer"):
        loader.load_checkpoint(d)


def test_strict_mode_reports_exact_names(bundles, tmp_path):
    """A deliberately renamed + missing-tensor checkpoint
    must fail with an actionable diagnostic listing the exact names."""
    from safetensors.numpy import save_file

    cfg, host, _, _ = bundles
    named = loader.export_torch_layout(host, cfg)
    # deliberately break it: drop one per-layer tensor, rename another to
    # something no alias rule can fix
    missing_name = "talker.model.layers.1.self_attn.q_proj.weight"
    renamed_src = "talker.model.layers.0.mlp.gate_proj.weight"
    named["talker.bogus_unknown.weight"] = named.pop(renamed_src)
    del named[missing_name]
    d = tmp_path / "broken"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    save_file({k: np.ascontiguousarray(v) for k, v in named.items()},
              str(d / "model.safetensors"))
    with pytest.raises(ValueError) as ei:
        loader.load_checkpoint(d)  # strict by default for torch layout
    msg = str(ei.value)
    assert missing_name in msg
    assert renamed_src in msg  # reported as the missing per-layer tensor
    assert "talker.bogus_unknown.weight" in msg  # unmatched source
    assert "RUNBOOK.md" in msg
    # non-strict still refuses nothing structural but logs; the model loads
    # only if all four groups exist — here they do, but blocks are partial,
    # so conversion drops the stack and unfilled targets are reported
    report = loader.diagnose_torch_checkpoint(d)
    assert not report.ok
    assert missing_name in report.missing_layer_tensors
    assert "talker.bogus_unknown.weight" in report.unmatched_sources
    assert any(t.startswith("talker/blocks/") for t in report.missing_targets)


def test_alias_table_normalizes_variant_names(bundles, tmp_path):
    """Plausible upstream naming variants (wrapping 'model.' prefix,
    'lm_head' for codec_head, ...) load identically through the alias
    tables, and the rename log records each fix."""
    from safetensors.numpy import save_file

    cfg, host, canon, _ = bundles
    named = loader.export_torch_layout(host, cfg)
    variant = {}
    for k, v in named.items():
        if k == "talker.codec_head.weight":
            k = "talker.lm_head.weight"  # exact alias
        elif k.startswith("speech_tokenizer."):
            k = "speech_tokenizer.model." + k[len("speech_tokenizer."):]
        elif k.startswith("speaker_encoder."):
            k = "spk_encoder." + k[len("speaker_encoder."):]
        else:
            k = "model." + k  # whole-model wrapper prefix
        variant[k] = v
    d = tmp_path / "variant"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    save_file({k: np.ascontiguousarray(v) for k, v in variant.items()},
              str(d / "model.safetensors"))
    report = loader.diagnose_torch_checkpoint(d)
    assert report.ok, report.summary()
    assert report.renamed["talker.lm_head.weight"] == "talker.codec_head.weight"
    assert len(report.renamed) == len(variant)
    cfg_a, a = loader.load_checkpoint(canon)
    cfg_b, b = loader.load_checkpoint(d)  # strict passes via aliases
    _flat_allclose(a, b)


def _write_torch_dir(tmp_path, cfg, named, name):
    from safetensors.numpy import save_file

    d = tmp_path / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    save_file({k: np.ascontiguousarray(v) for k, v in named.items()},
              str(d / "model.safetensors"))
    return d


def test_junk_aux_tensors_reported_and_pruned(bundles, tmp_path):
    """A tensor under the speech_tokenizer. prefix that maps to no model
    leaf (e.g. an EMA buffer) must be reported as an unexpected produced
    leaf — not silently injected into the bundle (advisor r3)."""
    cfg, host, _, _ = bundles
    named = loader.export_torch_layout(host, cfg)
    named["speech_tokenizer.quantizer.codebook_ema.weight"] = \
        np.zeros((4, 4), np.float32)
    d = _write_torch_dir(tmp_path, cfg, named, "junk_aux")
    report = loader.diagnose_torch_checkpoint(d)
    assert not report.ok
    assert any("codebook_ema" in t for t in report.unexpected_targets), \
        report.summary()
    assert "codebook_ema" in report.summary()
    # non-strict load prunes the junk leaf instead of uploading it
    rep2 = loader.ConversionReport()
    bundle = loader.convert_torch_checkpoint(
        dict(named), cfg, strict=False, report=rep2)
    assert not any("codebook_ema" in k for k in loader.flatten(bundle))


def test_nonweight_buffers_ignored(bundles, tmp_path):
    """num_batches_tracked / rotary inv_freq style bookkeeping buffers are
    dropped up front and never fail strict mode."""
    cfg, host, _, _ = bundles
    named = loader.export_torch_layout(host, cfg)
    named["speaker_encoder.block1.bn.num_batches_tracked"] = \
        np.zeros((), np.int64)
    named["talker.model.layers.0.self_attn.rotary_emb.inv_freq"] = \
        np.zeros((8,), np.float32)
    d = _write_torch_dir(tmp_path, cfg, named, "bookkeeping")
    report = loader.diagnose_torch_checkpoint(d)
    assert report.ok, report.summary()
    assert len(report.ignored) == 2
    loader.load_checkpoint(d)  # strict load passes


def test_alias_collision_not_silently_overwritten(bundles, tmp_path):
    """Two variant names that would rewrite to the same canonical key must
    not overwrite each other — the duplicate surfaces in the report."""
    cfg, host, _, _ = bundles
    named = loader.export_torch_layout(host, cfg)
    w = np.asarray(named.pop("talker.text_projection.weight"))
    # two DIFFERENT variant spellings of the same tensor; both alias-rewrite
    # to the canonical name — only one may land, the other must be reported
    named["model.talker.text_projection.weight"] = w
    named["talker.text_proj.weight"] = w + 1.0
    d = _write_torch_dir(tmp_path, cfg, named, "collision")
    report = loader.diagnose_torch_checkpoint(d)
    assert not report.ok
    assert len(report.unmatched_sources) == 1
    assert report.unmatched_sources[0] in (
        "model.talker.text_projection.weight", "talker.text_proj.weight")
    # exactly one of the two was accepted (no silent overwrite, no data loss
    # ambiguity): the canonical leaf exists and is one of the two candidates
    rep2 = loader.ConversionReport()
    bundle = loader.convert_torch_checkpoint(
        dict(named), cfg, strict=False, report=rep2)
    got = np.asarray(bundle["talker"]["text_projection"]["w"])
    assert got.shape == w.T.shape


def test_check_checkpoint_cli(bundles, capsys):
    """The check-checkpoint subcommand prints an OK report for a complete
    torch-layout dir and exits 0."""
    from qwen3tts_tpu.apps.cli import main

    _, _, _, torch_dir = bundles
    with pytest.raises(SystemExit) as ei:
        main(["check-checkpoint", str(torch_dir)])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert "OK" in out and "matched" in out


def test_model_size_normalization():
    assert normalize_model_size("0b6") == "0.6b"
    assert normalize_model_size("0.6B") == "0.6b"
    assert normalize_model_size("1b7") == "1.7b"
    cfg = TTSModelConfig.from_dict({"tts_model_size": "0b6", "talker_config": {}})
    assert cfg.model_size == "0.6b"


def test_0_6b_drops_instruct_1_7b_keeps_it(tiny_cfg, monkeypatch):
    """Reference model.py:849-850: the 0.6B CustomVoice model ignores
    ``instruct``; 1.7B keeps it.  Round-1 shipped ``"0.6b" in "0b6"`` which
    is always False — guard the normalized equality check."""
    import dataclasses

    from qwen3tts_tpu import FasterQwen3TTS
    from qwen3tts_tpu.core.loader import init_random

    seen = {}

    def fake_prepare(self, text, language, speaker, instruct):
        seen["instruct"] = instruct
        raise RuntimeError("stop")

    monkeypatch.setattr(FasterQwen3TTS, "_prepare_custom", fake_prepare)
    for size, expect in (("0b6", None), ("1.7b", "whisper")):
        cfg = dataclasses.replace(tiny_cfg, model_type="custom_voice", model_size=size)
        m = FasterQwen3TTS(cfg, init_random(cfg, dtype=cfg.jnp_dtype))
        with pytest.raises(RuntimeError):
            m.generate_custom_voice("hi", "vivian", "english", instruct="whisper")
        assert seen["instruct"] == expect, size
