"""HF-tokenizer branch: a tiny REAL tokenizer.json drives the chat templates.

Round 1 only ever exercised the byte-level fallback;
these tests build a genuine ``tokenizers.Tokenizer``, save its tokenizer.json,
and verify the template id layouts the prompt builder slices
(reference model.py:434-436: role = ids[:,:3], text = ids[:,3:-5] assistant /
[3:-2] ref) plus the from_pretrained threading.
"""
import logging

import numpy as np
import pytest

from qwen3tts_tpu.api.tokenizer import TextTokenizer


@pytest.fixture(scope="module")
def tok_json(tmp_path_factory):
    """A tiny real HF tokenizer with the chat-template special tokens."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<|im_start|>": 1, "<|im_end|>": 2, "\n": 3,
             "assistant": 4, "user": 5, "ref": 6,
             "hello": 7, "world": 8, "speak": 9, "softly": 10}
    t = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    t.save(str(path))
    return str(path)


def test_hf_branch_loads_and_sizes(tok_json):
    tt = TextTokenizer(tokenizer_json=tok_json)
    assert tt._hf is not None
    assert tt.vocab_size == 11


def test_assistant_template_layout(tok_json):
    """ids[:3] role block, ids[3:-5] text, 5-token suffix — the exact slices
    prompt.py consumes (reference model.py:434-436)."""
    tt = TextTokenizer(tokenizer_json=tok_json)
    ids = tt.build_assistant_ids("hello world")[0]
    assert list(ids[:3]) == [1, 4, 3]          # <|im_start|>, assistant, \n
    assert list(ids[3:-5]) == [7, 8]           # hello world
    assert list(ids[-5:-3]) == [2, 3]          # <|im_end|>, \n
    assert len(ids) == 3 + 2 + 5


def test_ref_and_instruct_template_layout(tok_json):
    tt = TextTokenizer(tokenizer_json=tok_json)
    ref = tt.build_ref_ids("speak softly")[0]
    assert list(ref[:3]) == [1, 6, 3]          # <|im_start|>, ref, \n
    assert list(ref[3:-2]) == [9, 10]
    assert list(ref[-2:]) == [2, 3]
    ins = tt.build_instruct_ids("speak")[0]
    assert list(ins[:3]) == [1, 5, 3]          # <|im_start|>, user, \n
    assert list(ins[3:-2]) == [9]


def test_unknown_words_map_to_unk_not_crash(tok_json):
    tt = TextTokenizer(tokenizer_json=tok_json)
    ids = tt.encode("zebra")
    assert ids == [0]


@pytest.mark.slow
def test_from_pretrained_threads_tokenizer_json(tmp_path, tok_json, caplog):
    """A checkpoint dir WITH tokenizer.json gets the HF tokenizer; one
    without warns loudly and falls back."""
    from pathlib import Path

    from qwen3tts_tpu import FasterQwen3TTS

    m = FasterQwen3TTS.from_pretrained("random:tiny")
    with_tok = tmp_path / "with_tok"
    m.save_pretrained(with_tok)
    (with_tok / "tokenizer.json").write_text(Path(tok_json).read_text())
    m2 = FasterQwen3TTS.from_pretrained(str(with_tok))
    assert m2.tokenizer._hf is not None
    assert m2.tokenizer.vocab_size == 11

    without = tmp_path / "without_tok"
    m.save_pretrained(without)
    with caplog.at_level(logging.WARNING):
        m3 = FasterQwen3TTS.from_pretrained(str(without))
    assert m3.tokenizer._hf is None
    assert any("tokenizer.json" in r.message for r in caplog.records)
