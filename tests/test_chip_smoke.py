"""chip_smoke.py (repo root): phase selection, the last-line contract, and
its refusal to report anything without a GPU.  The phases themselves need
the card; here each is replaced by a recorder."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PHASES = ("check_kernel_parity", "phase_decode_hlo", "time_attention_paths",
          "phase_clone",
          "phase_serve", "phase_modes", "phase_replicas",
          "phase_tensor_parallel")


class _FakeModel:
    pass


@pytest.fixture()
def recorded(monkeypatch):
    calls = []

    def recorder(name):
        def fn(*a, **k):
            calls.append(name)
            if name == "check_kernel_parity":
                return {"float32": 0.0, "bfloat16": 0.0}
            return []
        return fn

    for name in PHASES:
        monkeypatch.setattr(chip_smoke, name, recorder(name))

    def fake_device(jax, want):
        calls.append(f"device:{want}")
        return {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": want}

    monkeypatch.setattr(chip_smoke, "phase_device", fake_device)
    monkeypatch.setattr(chip_smoke, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    import qwen3tts_tpu

    monkeypatch.setattr(qwen3tts_tpu.FasterQwen3TTS, "from_pretrained",
                        classmethod(lambda cls, *a, **k: _FakeModel()))
    return calls


def test_default_run_phase_order(recorded, capsys):
    assert chip_smoke.main([]) == 0
    assert recorded == ["device:1", "check_kernel_parity", "phase_decode_hlo",
                        "time_attention_paths", "phase_clone", "phase_serve",
                        "phase_modes"]


def test_four_cards_runs_only_its_phases(recorded, capsys):
    assert chip_smoke.main(["--four-cards"]) == 0
    assert recorded == ["device:4", "phase_replicas", "phase_tensor_parallel"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["count"] == 4


def test_attention_grid_runs_only_parity_and_timing(recorded):
    assert chip_smoke.main(["--attention-grid"]) == 0
    assert recorded == ["device:1", "check_kernel_parity", "phase_decode_hlo",
                        "time_attention_paths"]


def test_last_line_format(recorded, capsys):
    chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_refuses_without_gpu(capsys):
    """On the CPU the device phase exits 2 and prints no result line."""
    import jax

    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_device(jax, 1)
    assert e.value.code == 2
    assert '"ok"' not in capsys.readouterr().out


def test_attention_grid_shapes_cover_the_decision():
    full = chip_smoke.attention_shapes(full=True)
    assert {(b, kvq) for _, b, _, _, kvq in full} == {
        (b, q) for b in (1, 8, 24) for q in (False, True)}
    for _, b, pos, pads, _ in full:
        assert len(pads) == b and max(pads) < pos < 2048


_STACKED, _LAYER = (28, 1, 2048, 8, 128), (1, 2048, 8, 128)


def _shape(dims):
    return "bf16[" + ",".join(map(str, dims)) + "]{4,3,2,1,0}"


def _hlo(body_lines, fused_lines=("  ROOT %dus.1 = " + _shape(_STACKED)
                                  + " dynamic-update-slice(%p.0, %p.1)",)):
    return "\n".join(
        ["HloModule m", "",
         "%fused_update (p.0: bf16[28,1,2048,8,128]) -> bf16[28,1,2048,8,128] {",
         *fused_lines, "}", "",
         "ENTRY %main.1 (k: bf16[28,1,2048,8,128]) -> bf16[28,1,2048,8,128] {",
         "  %k = " + _shape(_STACKED) + " parameter(0)",
         *body_lines, "}"])


_KERNEL = ("  %attn = (f32[1,8,16,2,128]{4,3,2,1,0}) custom-call(%q, %k), "
           'custom_call_target="__gpu$xla.gpu.triton"')
_UPDATE = ("  ROOT %upd = " + _shape(_STACKED)
           + " fusion(%k, %row), kind=kLoop, calls=%fused_update")


def _audit(body, **kw):
    return chip_smoke.hlo_cache_audit(_hlo(body, **kw), [_STACKED], [_LAYER])


def test_hlo_audit_clean_kernel_program():
    a = _audit([_KERNEL, _UPDATE])
    assert a == {"layer_buffers": [], "stacked_copies": [],
                 "stacked_updates": 1, "triton_calls": 1,
                 "kernel_reads_stacked": True}


@pytest.mark.parametrize("line,key", [
    ("  %c = " + _shape(_STACKED) + " copy(%k)", "stacked_copies"),
    ("  %ds = " + _shape(_LAYER) + " dynamic-slice(%k, %i)", "layer_buffers"),
    ("  %t = bf16[28,1,8,2048,128]{4,3,2,1,0} fusion(%k), kind=kInput, "
     "calls=%x", "stacked_copies"),
    ("  %f = " + _shape(_LAYER) + " fusion(%k), kind=kLoop, calls=%x",
     "layer_buffers"),
])
def test_hlo_audit_flags_materialised_cache(line, key):
    assert _audit([line, _KERNEL, _UPDATE])[key]


def test_hlo_audit_follows_bitcasts_to_the_stacked_cache():
    flat = "bf16[28,2048,1024]{2,1,0}"
    a = _audit(["  %kb = " + flat + " bitcast(%k)",
                _KERNEL.replace("%q, %k", "%q, %kb"), _UPDATE])
    assert a["kernel_reads_stacked"] and a["triton_calls"] == 1
    assert not _audit(["  %q = " + flat + " parameter(1)",
                       _KERNEL.replace("%q, %k", "%q"),
                       _UPDATE])["kernel_reads_stacked"]


def test_hlo_audit_update_not_rooted_in_dus_is_a_copy():
    a = _audit([_KERNEL, _UPDATE], fused_lines=(
        "  ROOT %cv = " + _shape(_STACKED) + " convert(%p.0)",))
    assert a["stacked_copies"] == ["upd (fusion)"] and a["stacked_updates"] == 0


def test_hlo_audit_ignores_slices_inside_fusions():
    a = _audit([_KERNEL, _UPDATE], fused_lines=(
        "  %ds = " + _shape(_LAYER) + " dynamic-slice(%p.0, %i)",
        "  ROOT %dus.1 = " + _shape(_STACKED)
        + " dynamic-update-slice(%p.0, %p.1)"))
    assert a["layer_buffers"] == [] and a["stacked_updates"] == 1
