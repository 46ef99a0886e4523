"""Checkpoint I/O: safetensors ⇄ JAX param pytrees, plus random presets.

Three entry paths for ``from_pretrained`` (reference model.py:71-152 loads via
HF hub; here weights are local-only — zero-egress environment):

  1. ``random:<preset>`` — deterministic random init of a preset architecture
     (tests/benchmarks; same FLOP profile as real weights).
  2. A directory containing ``config.json`` + ``model.safetensors`` in THIS
     framework's canonical flat layout (written by ``save_checkpoint``).
  3. A directory with upstream per-layer torch safetensors — converted via
     ``convert_torch_tree`` (names per SURVEY.md §2.2; per-layer tensors are
     stacked into the layer-stacked [L, ...] arrays used by lax.scan).
"""
from __future__ import annotations

import functools
import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import TTSModelConfig
from .presets import get_preset

logger = logging.getLogger(__name__)

SEP = "/"


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[: -len(SEP)]] = np.asarray(tree)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


# ---------------------------------------------------------------------------
# save / load (canonical format)
# ---------------------------------------------------------------------------


def save_checkpoint(path: str | Path, cfg: TTSModelConfig, bundle: Dict[str, Any]) -> None:
    """bundle: {"talker": ..., "predictor": ..., "codec": ..., "speaker": ...}"""
    from safetensors.numpy import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
    flat = flatten(bundle)
    # bf16 numpy arrays are supported by safetensors via their ml_dtypes repr.
    # ascontiguousarray: safetensors.numpy silently serializes the BASE buffer
    # of non-contiguous (e.g. transposed) arrays, scrambling the data.
    save_file({k: np.ascontiguousarray(v) for k, v in flat.items()},
              str(path / "model.safetensors"))


def _load_sharded_tensors(path: Path) -> Dict[str, np.ndarray]:
    """Read all weight tensors from a checkpoint dir: single
    ``model.safetensors``, or HF multi-file shards resolved through
    ``model.safetensors.index.json`` (falling back to a glob)."""
    from safetensors.numpy import load_file

    single = path / "model.safetensors"
    if single.exists():
        return dict(load_file(str(single)))
    index = path / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        shards = sorted(set(weight_map.values()))
    else:
        shards = sorted(p.name for p in path.glob("model-*-of-*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors weights found in {path}")
    out: Dict[str, np.ndarray] = {}
    for shard in shards:
        out.update(load_file(str(path / shard)))
    return out


def load_checkpoint(path: str | Path, dtype=None,
                    strict: bool | None = None) -> Tuple[TTSModelConfig, Dict[str, Any]]:
    """Load either layout (sniffed from config.json — reference
    from_pretrained accepts the upstream HF checkpoint dir, model.py:71-152):

      - canonical (this framework's ``save_checkpoint``): config.json carries
        the full nested dataclass dict under a top-level "talker" key;
      - upstream HF torch layout: "talker_config" key, torch tensor names in
        [out,in]/[Cout,Cin,K] layout, optionally sharded across
        ``model-XXXXX-of-YYYYY.safetensors`` files.

    ``strict`` (torch layout only) gates the conversion completeness check;
    default is strict ON (override with QWEN3TTS_LOADER_STRICT=0) so naming
    drift in real upstream weights fails with the exact tensor names instead
    of silently dropping them."""
    import os

    path = Path(path)
    raw_cfg = json.loads((path / "config.json").read_text())
    named = _load_sharded_tensors(path)
    if "talker" in raw_cfg:  # canonical format: flat names match our pytree
        cfg = _cfg_from_canonical(raw_cfg)
        bundle = unflatten(named)
    else:  # upstream torch layout → convert
        if strict is None:
            strict = os.environ.get("QWEN3TTS_LOADER_STRICT", "1") != "0"
        cfg = TTSModelConfig.from_dict(raw_cfg)
        bundle = convert_torch_checkpoint(named, cfg, strict=strict)
    target = dtype or cfg.jnp_dtype
    # dtype-cast on HOST, then ONE batched tree transfer
    # (core/packed_transfer.py) instead of ~200 per-leaf ones.  Only the talker /
    # predictor halves are cast to the model dtype; the codec and speaker
    # encoder keep their stored precision (waveform fidelity — init_random
    # makes the same split).
    from ..ops.initrand import fast_astype

    def cast_half(half, t):
        return jax.tree.map(
            lambda x: fast_astype(np.asarray(x), t)
            if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
            half,
        )

    bundle = {
        "talker": cast_half(bundle["talker"], target),
        "predictor": cast_half(bundle["predictor"], target),
        "codec": jax.tree.map(np.asarray, bundle["codec"]),
        "speaker": jax.tree.map(np.asarray, bundle["speaker"]),
    }
    from .packed_transfer import device_put_tree

    return cfg, device_put_tree(bundle)


def _cfg_from_canonical(raw: Dict[str, Any]) -> TTSModelConfig:
    import dataclasses

    from .config import (CodecConfig, PredictorConfig, SpeakerEncoderConfig,
                         TalkerConfig)

    def mk(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})

    top = {k: v for k, v in raw.items()
           if k in {f.name for f in dataclasses.fields(TTSModelConfig)}
           and k not in ("talker", "predictor", "codec", "speaker_encoder")}
    return TTSModelConfig(
        talker=mk(TalkerConfig, raw["talker"]),
        predictor=mk(PredictorConfig, raw["predictor"]),
        codec=mk(CodecConfig, raw["codec"]),
        speaker_encoder=mk(SpeakerEncoderConfig, raw["speaker_encoder"]),
        **top,
    )


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------


def init_random(cfg: TTSModelConfig, seed: int = 0, dtype=None) -> Dict[str, Any]:
    from ..models import codec as codec_lib
    from ..models import predictor as predictor_lib
    from ..models import speaker as speaker_lib
    from ..models import talker as talker_lib

    target = dtype or cfg.jnp_dtype

    # ONE jitted program initializes the whole bundle ON DEVICE: this host has
    # a single starved CPU core (host-side generation takes minutes) and every
    # separate device program costs seconds of dispatch latency; the compiled
    # init executable is persistently cached per (cfg, dtype).
    @functools.partial(jax.jit, static_argnums=(1,))
    def _init_bundle(key, target_name):
        t = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
             "float16": jnp.float16}[target_name]
        k = jax.random.split(key, 4)
        return {
            "talker": talker_lib.init_params(k[0], cfg.talker, t),
            "predictor": predictor_lib.init_params(
                k[1], cfg.predictor, cfg.talker.hidden_size, t),
            # codec + speaker stay f32 for waveform fidelity
            "codec": codec_lib.init_params(k[2], cfg.codec, jnp.float32),
            "speaker": speaker_lib.init_params(k[3], cfg.speaker_encoder,
                                               jnp.float32),
        }

    name = {jnp.bfloat16: "bfloat16", jnp.float32: "float32",
            jnp.float16: "float16"}[jnp.dtype(target).type if not isinstance(target, str) else jnp.dtype(target).type]
    return _init_bundle(jax.random.PRNGKey(seed), name)


def load_pretrained(model_name: str, dtype=None, seed: int = 0) -> Tuple[TTSModelConfig, Dict[str, Any]]:
    """Resolve a model reference: 'random:<preset>' or a checkpoint dir."""
    if model_name.startswith("random:"):
        cfg = get_preset(model_name.split(":", 1)[1])
        if dtype is not None:
            import dataclasses
            name = {jnp.bfloat16: "bfloat16", jnp.float32: "float32", jnp.float16: "float16"}[dtype]
            cfg = dataclasses.replace(cfg, dtype=name)
        return cfg, init_random(cfg, seed=seed, dtype=dtype)
    p = Path(model_name)
    if p.is_dir():
        return load_checkpoint(p, dtype=dtype)
    raise FileNotFoundError(
        f"Model '{model_name}' not found. Use 'random:<preset>' "
        f"or a local checkpoint directory (no network access in this environment)."
    )


# ---------------------------------------------------------------------------
# upstream torch-layout conversion (best-effort; SURVEY.md §2.2 name surface)
# ---------------------------------------------------------------------------

_TORCH_LAYER_RE = re.compile(
    r"talker\.model\.layers\.(\d+)\.(self_attn\.(?:q|k|v|o)_proj\.weight|"
    r"self_attn\.(?:q|k)_norm\.weight|input_layernorm\.weight|"
    r"post_attention_layernorm\.weight|mlp\.(?:gate|up|down)_proj\.weight)"
)

_BLOCK_KEY = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_norm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
}


def convert_torch_tree(named_tensors: Dict[str, np.ndarray], num_layers: int,
                       prefix: str = "talker.model",
                       consumed: set | None = None,
                       partial_out: list | None = None) -> Dict[str, Any]:
    """Stack upstream per-layer decoder tensors into the layer-stacked layout.

    Linear weights are transposed (torch stores [out,in]; we use [in,out]).
    ``consumed`` (if given) collects the source names that matched;
    ``partial_out`` collects the exact torch names of per-layer tensors that
    are MISSING from partially-populated stacks (strict-mode diagnostics).
    """
    layer_re = re.compile(
        re.escape(prefix)
        + r"\.layers\.(\d+)\.(self_attn\.(?:q|k|v|o)_proj\.weight|"
        r"self_attn\.(?:q|k)_norm\.weight|input_layernorm\.weight|"
        r"post_attention_layernorm\.weight|mlp\.(?:gate|up|down)_proj\.weight)"
    )
    per_layer: Dict[str, list] = {v: [None] * num_layers for v in _BLOCK_KEY.values()}
    for name, tensor in named_tensors.items():
        m = layer_re.fullmatch(name)
        if not m:
            continue
        li = int(m.group(1))
        if li >= num_layers:
            continue  # extra layers stay "unmatched sources" in the report
        key = _BLOCK_KEY[m.group(2)]
        t = np.asarray(tensor)
        if key.endswith("_proj"):
            t = t.T
        per_layer[key][li] = t
        if consumed is not None:
            consumed.add(name)
    if partial_out is not None:
        inv = {v: k for k, v in _BLOCK_KEY.items()}
        for key, vals in per_layer.items():
            holes = [i for i, x in enumerate(vals) if x is None]
            if holes and len(holes) < num_layers:
                partial_out.extend(
                    f"{prefix}.layers.{i}.{inv[key]}" for i in holes)
    stacked = {k: np.stack(v) for k, v in per_layer.items()
               if all(x is not None for x in v)}
    # checkpoints keep the upstream unfused names; the runtime uses fused
    # qkv/gateup matmuls (models/layers.py)
    if {"q_proj", "k_proj", "v_proj"} <= set(stacked):
        stacked["qkv_proj"] = np.concatenate(
            [stacked.pop("q_proj"), stacked.pop("k_proj"), stacked.pop("v_proj")],
            axis=-1)
    if {"gate_proj", "up_proj"} <= set(stacked):
        stacked["gateup_proj"] = np.concatenate(
            [stacked.pop("gate_proj"), stacked.pop("up_proj")], axis=-1)
    return stacked


# name → (our path, transpose?) for the non-layer tensors
_TALKER_TOP = {
    "talker.model.codec_embedding.weight": ("codec_embedding", False),
    "talker.model.text_embedding.weight": ("text_embedding", False),
    "talker.text_projection.weight": ("text_projection/w", True),
    "talker.text_projection.bias": ("text_projection/b", False),
    "talker.model.norm.weight": ("final_norm", False),
    "talker.codec_head.weight": ("codec_head", True),
    "talker.spk_proj.weight": ("spk_proj/w", True),
    "talker.spk_proj.bias": ("spk_proj/b", False),
}
_PRED_TOP = {
    "talker.code_predictor.small_to_mtp_projection.weight": ("small_to_mtp/w", True),
    "talker.code_predictor.small_to_mtp_projection.bias": ("small_to_mtp/b", False),
    "talker.code_predictor.model.norm.weight": ("final_norm", False),
}


# ---------------------------------------------------------------------------
# generic torch-layout bijection for the codec / speaker halves
#
# The upstream hides these models behind ``speech_tokenizer`` /
# ``create_voice_clone_prompt`` (SURVEY.md §2.2), so their exact state-dict
# names are not pinned by the reference repo.  The mapping below is the
# DESIGNED landing point: a systematic bijection between our pytree and torch
# naming/layout conventions ([out,in] linears, [Cout,Cin,K] convs, ModuleList
# indices).  When real weights land, only the name prefix table needs
# adjusting; the mechanics (stacking, transposes, shard handling) are proven
# by tests/test_torch_checkpoint.py round-trips.
# ---------------------------------------------------------------------------


def export_aux_tree(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """Our pytree → torch-named tensors.  Leaf 'w' → '.weight' (rank-2
    transposed to [out,in]; rank-3 conv to [Cout,Cin,K]); 'b' → '.bias';
    every other leaf keeps its name and layout."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in flatten(tree, prefix + SEP).items():
        parts = path.split(SEP)
        name = parts[-1]
        t = np.asarray(leaf)
        if name == "w":
            parts[-1] = "weight"
            t = t.transpose(2, 1, 0) if t.ndim == 3 else t.T
        elif name == "b":
            parts[-1] = "bias"
        out[".".join(parts)] = t
    return out


def convert_aux_tree(named_tensors: Dict[str, np.ndarray], prefix: str,
                     consumed: set | None = None) -> Any:
    """Inverse of ``export_aux_tree``: torch-named tensors under ``prefix`` →
    our nested pytree.  Returns None if no tensors carry the prefix."""
    flat: Dict[str, np.ndarray] = {}
    pfx = prefix + "."
    for name, tensor in named_tensors.items():
        if not name.startswith(pfx):
            continue
        parts = name[len(pfx):].split(".")
        t = np.asarray(tensor)
        if parts[-1] == "weight":
            parts[-1] = "w"
            t = t.transpose(2, 1, 0) if t.ndim == 3 else t.T
        elif parts[-1] == "bias":
            parts[-1] = "b"
        flat[SEP.join(parts)] = t
        if consumed is not None:
            consumed.add(name)
    return unflatten(flat) if flat else None


# ---------------------------------------------------------------------------
# naming aliases for plausible upstream variants
#
# The published Qwen3-TTS state-dict names are unverifiable in this
# zero-egress environment (TODO.md), so conversion accepts a set of
# NORMALIZING aliases: each rule rewrites a name that matches NO conversion
# pattern into one that does.  Extend these tables first when real weights
# land with different names — the strict-mode report (below) prints the exact
# leftover names to alias.  See RUNBOOK.md for the full procedure.
# ---------------------------------------------------------------------------

# torch bookkeeping buffers that are never model weights: dropped before
# conversion (reported under report.ignored, not as errors)
_NONWEIGHT_RE = re.compile(
    r"\.(num_batches_tracked|attn\.masked_bias|rotary_emb\.inv_freq)$")

# (variant_prefix, canonical_prefix) — tried in order, first hit wins
_PREFIX_ALIASES = [
    ("model.", ""),                      # whole-model "model." wrapper
    ("tts_model.", ""),
    ("talker.language_model.model.", "talker.model."),
    ("talker.language_model.", "talker.model."),
    ("talker.transformer.", "talker.model."),
    ("talker.model.code_predictor.", "talker.code_predictor."),
    ("code_predictor.", "talker.code_predictor."),
    ("speech_tokenizer.model.", "speech_tokenizer."),
    ("codec.", "speech_tokenizer."),
    ("audio_tokenizer.", "speech_tokenizer."),
    ("spk_encoder.", "speaker_encoder."),
    ("speaker_model.", "speaker_encoder."),
    ("xvector_model.", "speaker_encoder."),
]

# exact-name variants (leaf-level renames)
_EXACT_ALIASES = {
    "talker.model.embed_tokens.weight": "talker.model.codec_embedding.weight",
    "talker.lm_head.weight": "talker.codec_head.weight",
    "talker.model.text_embed.weight": "talker.model.text_embedding.weight",
    "talker.text_proj.weight": "talker.text_projection.weight",
    "talker.text_proj.bias": "talker.text_projection.bias",
    "talker.speaker_projection.weight": "talker.spk_proj.weight",
    "talker.speaker_projection.bias": "talker.spk_proj.bias",
}

_LAYER_SUFFIX_RE = (
    r"\.layers\.\d+\.(self_attn\.(?:q|k|v|o)_proj\.weight|"
    r"self_attn\.(?:q|k)_norm\.weight|input_layernorm\.weight|"
    r"post_attention_layernorm\.weight|mlp\.(?:gate|up|down)_proj\.weight)"
)
_RECOGNIZED_RE = re.compile(
    "|".join([
        re.escape("talker.model") + _LAYER_SUFFIX_RE,
        re.escape("talker.code_predictor.model") + _LAYER_SUFFIX_RE,
        r"talker\.code_predictor\.lm_head\.\d+\.weight",
        r"talker\.code_predictor\.model\.codec_embedding\.\d+\.weight",
    ])
)

_AUX_PREFIX = {"codec": "speech_tokenizer", "speaker": "speaker_encoder"}


def _aux_torch_names(expected_paths) -> set:
    """Canonical torch names for the codec/speaker halves, derived from the
    expected pytree paths (the aux conversion is a mechanical bijection, so
    the full legal name set is computable — and alias rules can target it
    exactly instead of accepting any name under the prefix)."""
    names = set()
    for p in expected_paths:
        parts = p.split(SEP)
        prefix = _AUX_PREFIX.get(parts[0])
        if prefix is None:
            continue
        rest = parts[1:]
        if rest and rest[-1] == "w":
            rest[-1] = "weight"
        elif rest and rest[-1] == "b":
            rest[-1] = "bias"
        names.add(".".join([prefix] + rest))
    return names


def _recognized(name: str, aux_names: set | None = None) -> bool:
    if (name in _TALKER_TOP or name in _PRED_TOP
            or _RECOGNIZED_RE.fullmatch(name) is not None):
        return True
    if aux_names is not None:
        return name in aux_names
    return name.startswith(("speech_tokenizer.", "speaker_encoder."))


def apply_name_aliases(
    named_tensors: Dict[str, np.ndarray],
    aux_names: set | None = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Rewrite unrecognized tensor names through the alias tables.  A rename
    only happens when the original name matches no conversion rule AND the
    rewritten name does (so canonical checkpoints pass through untouched).
    ``aux_names``: exact legal codec/speaker names (else prefix match).
    Returns (renamed_dict, {original: canonical} log)."""
    out: Dict[str, np.ndarray] = {}
    renames: Dict[str, str] = {}
    for name, tensor in named_tensors.items():
        if _recognized(name, aux_names):
            out[name] = tensor
            continue
        cand = _EXACT_ALIASES.get(name)
        if (cand is None or not _recognized(cand, aux_names)
                or cand in named_tensors):
            cand = None
            for variant, canon in _PREFIX_ALIASES:
                if name.startswith(variant):
                    rewritten = canon + name[len(variant):]
                    # one more exact-alias hop after the prefix strip
                    rewritten = _EXACT_ALIASES.get(rewritten, rewritten)
                    if (_recognized(rewritten, aux_names)
                            and rewritten not in named_tensors):
                        cand = rewritten
                        break
        if cand is not None and cand in out:
            # two variant names rewrote to the same canonical key — keep the
            # first, leave this one under its original (unrecognized) name so
            # strict mode reports it instead of silently overwriting
            cand = None
        if cand is not None:
            renames[name] = cand
            out[cand] = tensor
        else:
            out[name] = tensor
    return out, renames


# ---------------------------------------------------------------------------
# strict-mode conversion report
# ---------------------------------------------------------------------------


def expected_bundle_shapes(cfg: TTSModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat {pytree path: shape} of a COMPLETE bundle for ``cfg`` — derived
    by shape-tracing the init functions (no FLOPs, no device work)."""
    from ..models import codec as codec_lib
    from ..models import predictor as predictor_lib
    from ..models import speaker as speaker_lib
    from ..models import talker as talker_lib

    def build(key):
        return {
            "talker": talker_lib.init_params(key, cfg.talker, jnp.float32),
            "predictor": predictor_lib.init_params(
                key, cfg.predictor, cfg.talker.hidden_size, jnp.float32),
            "codec": codec_lib.init_params(key, cfg.codec, jnp.float32),
            "speaker": speaker_lib.init_params(key, cfg.speaker_encoder,
                                               jnp.float32),
        }

    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))

    # flatten() would np.asarray each leaf, collapsing ShapeDtypeStructs to
    # 0-d object scalars — walk the tree keeping the structs intact instead
    def walk(node, prefix, out):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}{SEP}", out)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}{SEP}", out)
        else:
            out[prefix[: -len(SEP)]] = tuple(node.shape)

    out: Dict[str, Tuple[int, ...]] = {}
    walk(shapes, "", out)
    return out


class ConversionReport:
    """Diagnostics from a torch-checkpoint conversion: what matched, what was
    renamed, what's left over on either side.  ``raise_if_bad()`` is the
    strict mode — it fails with every exact name in the message so a naming
    drift in real upstream weights is a 5-minute alias-table fix, not a
    silent quality bug."""

    def __init__(self):
        self.matched = 0
        self.renamed: Dict[str, str] = {}
        self.unmatched_sources: list[str] = []
        self.missing_targets: list[str] = []
        self.missing_layer_tensors: list[str] = []
        self.missing_groups: list[str] = []
        self.shape_mismatches: list[Tuple[str, tuple, tuple]] = []
        self.unexpected_targets: list[str] = []
        self.ignored: list[str] = []  # well-known non-weight buffers, dropped

    @property
    def ok(self) -> bool:
        return not (self.unmatched_sources or self.missing_targets
                    or self.missing_layer_tensors or self.missing_groups
                    or self.shape_mismatches or self.unexpected_targets)

    def _section(self, title, items, limit=30):
        if not items:
            return []
        lines = [f"  {title} ({len(items)}):"]
        for it in items[:limit]:
            lines.append(f"    - {it}")
        if len(items) > limit:
            lines.append(f"    ... and {len(items) - limit} more")
        return lines

    def summary(self, limit: int = 30) -> str:
        lines = [f"conversion report: {self.matched} tensors matched, "
                 f"{len(self.renamed)} renamed via aliases, "
                 f"{'OK' if self.ok else 'PROBLEMS FOUND'}"]
        lines += self._section(
            "renamed (variant → canonical)",
            [f"{a} → {b}" for a, b in sorted(self.renamed.items())], limit)
        lines += self._section(
            "MISSING tensor groups (no tensors at all for these sub-models)",
            sorted(self.missing_groups), limit)
        lines += self._section(
            "UNMATCHED source tensors (no conversion rule; add an alias "
            "in core/loader.py or ignore if non-weight)",
            sorted(self.unmatched_sources), limit)
        lines += self._section(
            "MISSING per-layer tensors (expected torch names)",
            sorted(self.missing_layer_tensors), limit)
        lines += self._section(
            "UNFILLED target leaves (our pytree paths the checkpoint "
            "never produced)", sorted(self.missing_targets), limit)
        lines += self._section(
            "SHAPE mismatches (path: got vs expected)",
            [f"{p}: {g} vs {e}" for p, g, e in self.shape_mismatches], limit)
        lines += self._section(
            "UNEXPECTED produced leaves (source tensors that converted into "
            "pytree paths the model does not define — e.g. EMA/statistics "
            "buffers under speech_tokenizer./speaker_encoder.)",
            sorted(self.unexpected_targets), limit)
        lines += self._section(
            "ignored non-weight buffers (dropped, not an error)",
            sorted(self.ignored), limit)
        return "\n".join(lines)

    def raise_if_bad(self):
        if not self.ok:
            raise ValueError(
                "torch-checkpoint conversion is incomplete — refusing to "
                "load a partial model (pass strict=False to force).\n"
                + self.summary()
                + "\nSee RUNBOOK.md for the weight-conversion procedure.")


def convert_torch_checkpoint(
    named_tensors: Dict[str, np.ndarray],
    cfg: TTSModelConfig,
    *,
    strict: bool = False,
    report: ConversionReport | None = None,
) -> Dict[str, Any]:
    """Conversion of an upstream torch-layout state dict into a full
    {'talker', 'predictor', 'codec', 'speaker'} bundle (SURVEY.md §2.2
    surface: per-codebook ModuleLists become stacked arrays; per-layer decoder
    tensors become lax.scan-ready [L, ...] stacks; codec/speaker trees convert
    through the generic bijection above).

    Unrecognized names are first normalized through the alias tables.  With
    ``strict=True`` every unmatched source tensor, unfilled target leaf and
    shape mismatch is reported in one actionable error (the readiness
    guarantee for real upstream weights — reference parity tests
    tests/test_e2e_parity.py:411-580 presume a correct load)."""
    if report is None:
        report = ConversionReport()
    expected = expected_bundle_shapes(cfg)
    # drop well-known torch bookkeeping buffers up front: they are not
    # weights and must neither demand an alias entry nor leak into the aux
    # prefix conversion (convert_aux_tree consumes anything under its prefix)
    dropped = [n for n in named_tensors if _NONWEIGHT_RE.search(n)]
    if dropped:
        named_tensors = {n: t for n, t in named_tensors.items()
                         if not _NONWEIGHT_RE.search(n)}
        report.ignored = sorted(dropped)
    named_tensors, report.renamed = apply_name_aliases(
        named_tensors, _aux_torch_names(expected))
    consumed: set = set()
    talker: Dict[str, Any] = {
        "blocks": convert_torch_tree(
            named_tensors, cfg.talker.num_hidden_layers, "talker.model",
            consumed=consumed, partial_out=report.missing_layer_tensors),
    }
    predictor: Dict[str, Any] = {
        "blocks": convert_torch_tree(
            named_tensors, cfg.predictor.num_hidden_layers,
            "talker.code_predictor.model",
            consumed=consumed, partial_out=report.missing_layer_tensors),
    }
    flat_t: Dict[str, np.ndarray] = {}
    flat_p: Dict[str, np.ndarray] = {}
    for name, tensor in named_tensors.items():
        t = np.asarray(tensor)
        if name in _TALKER_TOP:
            path, transpose = _TALKER_TOP[name]
            flat_t[path] = t.T if transpose else t
            consumed.add(name)
        elif name in _PRED_TOP:
            path, transpose = _PRED_TOP[name]
            flat_p[path] = t.T if transpose else t
            consumed.add(name)

    # per-codebook ModuleLists → stacked arrays
    nc = cfg.predictor.num_codebooks
    head_names = [f"talker.code_predictor.lm_head.{i}.weight"
                  for i in range(nc)]
    heads = [named_tensors.get(n) for n in head_names]
    if all(h is not None for h in heads):
        flat_p["lm_heads"] = np.stack([np.asarray(h).T for h in heads])
        consumed.update(head_names)
    else:
        report.missing_layer_tensors.extend(
            n for n, h in zip(head_names, heads) if h is None)
        consumed.update(n for n, h in zip(head_names, heads) if h is not None)
    embed_names = [f"talker.code_predictor.model.codec_embedding.{i}.weight"
                   for i in range(nc)]
    embeds = [named_tensors.get(n) for n in embed_names]
    if all(e is not None for e in embeds):
        flat_p["codec_embeddings"] = np.stack([np.asarray(e) for e in embeds])
        consumed.update(embed_names)
    else:
        report.missing_layer_tensors.extend(
            n for n, e in zip(embed_names, embeds) if e is None)
        consumed.update(n for n, e in zip(embed_names, embeds) if e is not None)

    talker.update(unflatten(flat_t))
    predictor.update(unflatten(flat_p))

    codec = convert_aux_tree(named_tensors, "speech_tokenizer",
                             consumed=consumed)
    speaker = convert_aux_tree(named_tensors, "speaker_encoder",
                               consumed=consumed)

    report.unmatched_sources = [n for n in named_tensors if n not in consumed]
    report.missing_groups = [
        n for n, half in (("speech_tokenizer (codec)", codec),
                          ("speaker_encoder", speaker)) if half is None]
    bundle = {"talker": talker, "predictor": predictor,
              "codec": codec if codec is not None else {},
              "speaker": speaker if speaker is not None else {}}
    produced = {k: tuple(np.shape(v)) for k, v in flatten(bundle).items()}
    report.missing_targets = sorted(set(expected) - set(produced))
    report.shape_mismatches = [
        (k, produced[k], expected[k])
        for k in sorted(set(produced) & set(expected))
        if produced[k] != expected[k]
    ]
    # convert_aux_tree consumes ANY tensor under its prefix, so junk sources
    # (EMA buffers, num_batches_tracked, …) become extra pytree leaves the
    # model never defined: report them, and prune so they are never cast or
    # uploaded to device
    report.unexpected_targets = sorted(set(produced) - set(expected))
    if report.unexpected_targets:
        flat_all = flatten(bundle)
        for k in report.unexpected_targets:
            del flat_all[k]
        bundle = unflatten(flat_all)
    report.matched = len(consumed)

    if strict:
        report.raise_if_bad()
    elif not report.ok:
        logger.warning("torch-checkpoint conversion problems:\n%s",
                       report.summary())
    missing = [n for n, half in (("speech_tokenizer", codec),
                                 ("speaker_encoder", speaker)) if half is None]
    if missing:
        raise ValueError(
            f"checkpoint is missing the {missing} tensor group(s); a partial "
            "model cannot synthesize audio. Convert/merge all four sub-models "
            "into one checkpoint dir (see core/loader.py docstring and "
            "RUNBOOK.md)."
        )
    return bundle


def export_torch_layout(bundle: Dict[str, Any], cfg: TTSModelConfig) -> Dict[str, np.ndarray]:
    """Inverse of convert_torch_checkpoint (talker+predictor halves) — used by
    the round-trip test and for interop with torch tooling."""
    out: Dict[str, np.ndarray] = {}

    def put_blocks(blocks, prefix, q_dim, kv_dim, inter):
        inv = {v: k for k, v in _BLOCK_KEY.items()}
        qkv = np.asarray(blocks["qkv_proj"])
        gu = np.asarray(blocks["gateup_proj"])
        unfused = dict(blocks)
        unfused["q_proj"] = qkv[..., :q_dim]
        unfused["k_proj"] = qkv[..., q_dim : q_dim + kv_dim]
        unfused["v_proj"] = qkv[..., q_dim + kv_dim :]
        unfused["gate_proj"] = gu[..., :inter]
        unfused["up_proj"] = gu[..., inter:]
        L = qkv.shape[0]
        for our, torch_key in inv.items():
            arr = np.asarray(unfused[our])
            for li in range(L):
                t = arr[li]
                if our.endswith("_proj"):
                    t = t.T
                out[f"{prefix}.layers.{li}.{torch_key}"] = t

    tk, pd = cfg.talker, cfg.predictor
    put_blocks(bundle["talker"]["blocks"], "talker.model",
               tk.num_attention_heads * tk.head_dim,
               tk.num_key_value_heads * tk.head_dim, tk.intermediate_size)
    put_blocks(bundle["predictor"]["blocks"], "talker.code_predictor.model",
               pd.num_attention_heads * pd.head_dim,
               pd.num_key_value_heads * pd.head_dim, pd.intermediate_size)
    for name, (path, transpose) in _TALKER_TOP.items():
        leaf = bundle["talker"]
        for part in path.split("/"):
            leaf = leaf[part]
        out[name] = np.asarray(leaf).T if transpose else np.asarray(leaf)
    for name, (path, transpose) in _PRED_TOP.items():
        leaf = bundle["predictor"]
        for part in path.split("/"):
            leaf = leaf[part]
        out[name] = np.asarray(leaf).T if transpose else np.asarray(leaf)
    lm = np.asarray(bundle["predictor"]["lm_heads"])
    ce = np.asarray(bundle["predictor"]["codec_embeddings"])
    for i in range(lm.shape[0]):
        out[f"talker.code_predictor.lm_head.{i}.weight"] = lm[i].T
        out[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = ce[i]
    if "codec" in bundle:
        out.update(export_aux_tree(bundle["codec"], "speech_tokenizer"))
    if "speaker" in bundle:
        out.update(export_aux_tree(bundle["speaker"], "speaker_encoder"))
    return out


def export_torch_checkpoint(
    path: str | Path,
    cfg: TTSModelConfig,
    bundle: Dict[str, Any],
    num_shards: int = 1,
    tokenizer_json: str | None = None,
) -> None:
    """Write an upstream-HF-layout checkpoint dir: HF-style config.json,
    torch-named/[out,in]-layout tensors across ``num_shards`` safetensors
    files with an index.json, optional tokenizer.json.  This is the one-command
    export whose inverse is ``load_checkpoint``'s torch branch — and the
    format golden fixtures/conversions are tested against."""
    from safetensors.numpy import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg.to_hf_dict(), indent=2))
    # ascontiguousarray: the export transposes to torch layout, and
    # safetensors.numpy silently serializes base buffers of views
    named = {k: np.ascontiguousarray(v)
             for k, v in export_torch_layout(bundle, cfg).items()}
    names = sorted(named)
    if num_shards <= 1:
        save_file({n: named[n] for n in names}, str(path / "model.safetensors"))
    else:
        per = -(-len(names) // num_shards)
        weight_map: Dict[str, str] = {}
        for si in range(num_shards):
            shard_names = names[si * per : (si + 1) * per]
            fname = f"model-{si + 1:05d}-of-{num_shards:05d}.safetensors"
            save_file({n: named[n] for n in shard_names}, str(path / fname))
            weight_map.update({n: fname for n in shard_names})
        (path / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}, indent=2))
    if tokenizer_json:
        (path / "tokenizer.json").write_text(Path(tokenizer_json).read_text())


def diagnose_torch_checkpoint(path: str | Path) -> ConversionReport:
    """Dry-run the torch-layout conversion of a checkpoint dir and return the
    full report (never raises on conversion problems).  CLI:
    ``qwen3tts-tpu check-checkpoint <dir>``.  This is the first step of the
    real-weights runbook (RUNBOOK.md)."""
    path = Path(path)
    raw_cfg = json.loads((path / "config.json").read_text())
    if "talker" in raw_cfg:
        raise ValueError(
            f"{path} is a canonical-format checkpoint (no conversion "
            "involved); diagnosis applies to upstream torch-layout dirs")
    cfg = TTSModelConfig.from_dict(raw_cfg)
    named = _load_sharded_tensors(path)
    report = ConversionReport()
    try:
        convert_torch_checkpoint(named, cfg, strict=False, report=report)
    except ValueError:
        pass  # missing-group raise — everything is already in the report
    return report
