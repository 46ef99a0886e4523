"""RUNBOOK step 1-3 rehearsal at REAL 0.6B geometry.

``test_torch_checkpoint.py`` proves the converter on a tiny config; this
module synthesizes an upstream-layout SHARDED checkpoint at the full
flagship geometry — the 28-layer/1024-hidden talker, real codec/speaker
dims, multi-file ``model-0000X-of-0000Y.safetensors`` + index.json +
tokenizer.json, bf16 on disk (the dtype the published weights ship in,
reference model.py:71-152) — and drives the exact commands RUNBOOK.md
step 1 prescribes the day real weights land:

  check-checkpoint → load_checkpoint (leafwise equality vs the source
  bundle) → naming-drift diagnostics at full size.

The generate/fixture legs of the loop are covered at tiny geometry
(test_torch_checkpoint.py::test_from_pretrained_torch_dir_generates_same_tokens)
— compiling the flagship engine on the 1-core CPU test host costs minutes
and adds no conversion coverage; conversion risk (name maps, shard
splitting, layout transposes, index bookkeeping) is geometry-dependent and
is what this rehearses.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qwen3tts_tpu.core import loader
from qwen3tts_tpu.core.presets import get_preset
from qwen3tts_tpu.parallel.sharding import _host_init_tree


@pytest.fixture(scope="module")
def flagship_torch_dir(tmp_path_factory):
    """A full-geometry upstream-layout dir: 4 shards, index, tokenizer."""
    cfg = get_preset("qwen3-tts-0.6b")
    shapes = jax.eval_shape(lambda: loader.init_random(cfg, seed=0,
                                                       dtype=jnp.bfloat16))
    bundle = _host_init_tree(shapes, seed=0)
    host = jax.tree.map(np.asarray, bundle)
    root = tmp_path_factory.mktemp("flagship_ckpt")
    d = root / "qwen3-tts-0.6b-torch"
    tok = root / "tokenizer.json"
    # minimal-but-real tokenizers file so the tokenizer.json threading runs
    tok.write_text(json.dumps({
        "version": "1.0",
        "truncation": None, "padding": None,
        "added_tokens": [], "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None, "decoder": None,
        "model": {"type": "WordLevel",
                  "vocab": {chr(c): c - 97 for c in range(97, 123)},
                  "unk_token": "a"},
    }))
    loader.export_torch_checkpoint(d, cfg, host, num_shards=4,
                                   tokenizer_json=str(tok))
    return cfg, host, d


@pytest.mark.slow
def test_flagship_sharded_layout_on_disk(flagship_torch_dir):
    """The synthesized dir has the published-weights shape at full size."""
    _, _, d = flagship_torch_dir
    shards = sorted(p.name for p in d.glob("model-*-of-*.safetensors"))
    assert len(shards) == 4, shards
    index = json.loads((d / "model.safetensors.index.json").read_text())
    names = set(index["weight_map"])
    # every talker layer of the real 28-layer stack is present by name
    for i in range(28):
        assert f"talker.model.layers.{i}.self_attn.q_proj.weight" in names, i
    assert (d / "tokenizer.json").exists()
    raw = json.loads((d / "config.json").read_text())
    assert raw["talker_config"]["num_hidden_layers"] == 28
    assert raw["talker_config"]["hidden_size"] == 1024
    # the index's sizes add up to > 1 GB — this is a real-scale rehearsal
    total = sum((d / s).stat().st_size for s in shards)
    assert total > 2 ** 30, total


@pytest.mark.slow
def test_flagship_check_checkpoint_cli(flagship_torch_dir, capsys):
    """RUNBOOK step 1: `qwen3tts-tpu check-checkpoint <dir>` exits 0 with an
    OK report at full geometry."""
    from qwen3tts_tpu.apps.cli import main

    _, _, d = flagship_torch_dir
    with pytest.raises(SystemExit) as ei:
        main(["check-checkpoint", str(d)])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert "OK" in out and "matched" in out


@pytest.mark.slow
def test_flagship_load_roundtrip(flagship_torch_dir):
    """RUNBOOK step 2: load_checkpoint on the sharded full-size dir returns
    the exact source bundle (every leaf, bitwise) and the real config."""
    cfg, host, d = flagship_torch_dir
    cfg_b, b = loader.load_checkpoint(d)
    assert cfg_b.talker.num_hidden_layers == cfg.talker.num_hidden_layers
    assert cfg_b.talker.hidden_size == cfg.talker.hidden_size
    fa, fb = loader.flatten(host), loader.flatten(jax.tree.map(np.asarray, b))
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        np.testing.assert_array_equal(
            np.asarray(fa[k], np.float32), np.asarray(fb[k], np.float32),
            err_msg=k)


@pytest.mark.slow
def test_flagship_naming_drift_diagnostics(flagship_torch_dir, tmp_path):
    """RUNBOOK step 3 contingency: if upstream names drifted, the diagnostic
    at FULL geometry names the exact tensors — a mid-stack rename and a
    deleted deep-layer tensor both surface, with the RUNBOOK pointer."""
    cfg, host, _ = flagship_torch_dir
    named = loader.export_torch_layout(host, cfg)
    missing = "talker.model.layers.27.mlp.down_proj.weight"
    renamed_src = "talker.model.layers.13.self_attn.k_proj.weight"
    named["talker.model.layers.13.self_attn.key_projection.weight"] = \
        named.pop(renamed_src)
    del named[missing]
    d = tmp_path / "drifted"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    from safetensors.numpy import save_file
    save_file({k: np.ascontiguousarray(v) for k, v in named.items()},
              str(d / "model.safetensors"))
    report = loader.diagnose_torch_checkpoint(d)
    assert not report.ok
    assert missing in report.missing_layer_tensors
    assert ("talker.model.layers.13.self_attn.key_projection.weight"
            in report.unmatched_sources)
    with pytest.raises(ValueError) as ei:
        loader.load_checkpoint(d)
    msg = str(ei.value)
    assert missing in msg and "RUNBOOK.md" in msg
