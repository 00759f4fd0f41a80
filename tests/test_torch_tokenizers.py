"""The port's tokenizers against the JAX package's, on the CPU.

* SentencePiece (the C++ merge loop and its plain Python version) and Tekken
  give the JAX package's ids and decoded text on the fixtures of
  tests/test_tokenizers.py and tests/test_chat_golden.py and on drawn text.
* Every golden of tests/test_chat_golden.py (chat, tools, FIM; SPM v3 and
  Tekken) gives the same ids through the port's ``chat.py``.
* ``encode_chat_multimodal`` with an image gives the JAX package's ids and
  images.
* A failed native build raises with the compiler's output.

Drawn text is any string of assigned Unicode characters (categories Cs and
Cn left out: a surrogate has no UTF-8 form, and an unassigned code point's
class depends on which Unicode version a regex engine was built with).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

import test_chat_golden as golden
import test_tokenizers as tiny
from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs
from mistral_inference_tpu.tokenizers import chat as jax_chat
from mistral_inference_tpu.tokenizers import load_tokenizer as jax_load_tokenizer
from mistral_inference_tpu.tokenizers.spm import SentencePieceBPE as JaxSPM
from mistral_inference_tpu.tokenizers.spm import parse_model_proto as jax_parse
from mistral_inference_tpu.tokenizers.tekken import Tekken as JaxTekken
from mistral_inference_tpu_torch import native
from mistral_inference_tpu_torch.args import VisionEncoderArgs
from mistral_inference_tpu_torch.tokenizers import chat, load_tokenizer
from mistral_inference_tpu_torch.tokenizers.spm import WS, SentencePieceBPE, parse_model_proto
from mistral_inference_tpu_torch.tokenizers.tekken import Tekken

TEXT = hst.text(hst.characters(exclude_categories=("Cs", "Cn")), max_size=40)
SAMPLES = ["hello world", "he", "héllo wörld", "", "hello hello hello world w o r",
           "[INST] hello [/INST]", "x </s> y", "  two  spaces\n\tand\ttabs ", "日本語 🙂"]


def _spm_pair(model_bytes: bytes, merge: str):
    return (JaxSPM(jax_parse(model_bytes)),
            SentencePieceBPE(parse_model_proto(model_bytes), merge=merge))


def _tekken_pair(tmp_path, cfg):
    p = tmp_path / "tekken.json"
    p.write_text(json.dumps(cfg))
    return JaxTekken.from_file(p), Tekken.from_file(p)


@pytest.fixture(scope="module")
def tekken_pairs(tmp_path_factory):
    """(JAX, port) Tekken on the two fixtures: the tiny one with merges and
    the chat goldens' one."""
    out = []
    for cfg in (tiny.tiny_tekken_cfg(), _golden_tekken_cfg()):
        out.append(_tekken_pair(tmp_path_factory.mktemp("tek"), cfg))
    return out


def _golden_tekken_cfg():
    import base64

    vocab = [{"rank": i, "token_bytes": base64.b64encode(bytes([i])).decode()}
             for i in range(256)]
    return {"config": {"pattern": r"\s+|\S+", "default_vocab_size": 256 + 20,
                       "default_num_special_tokens": 20, "version": "v3"}, "vocab": vocab}


def _check_same(jtok, tok, text):
    for bos, eos in ((True, False), (False, True)):
        ids = tok.encode(text, bos=bos, eos=eos)
        assert ids == jtok.encode(text, bos=bos, eos=eos), text
    assert tok.decode(ids) == jtok.decode(ids), text


@pytest.mark.parametrize("merge", ["native", "python"])
@pytest.mark.parametrize("fixture", ["tiny", "v3"])
def test_spm_matches_jax_on_samples(fixture, merge):
    model_bytes = tiny.tiny_spm_model() if fixture == "tiny" else golden.spm_v3_model()
    jtok, tok = _spm_pair(model_bytes, merge)
    for text in SAMPLES:
        _check_same(jtok, tok, text)
    assert tok.special_by_name == jtok.special_by_name


@settings(max_examples=60, deadline=None)
@given(text=TEXT)
def test_spm_native_and_python_match_jax_on_drawn_text(text):
    jtok, tok = _spm_pair(tiny.tiny_spm_model(), "native")
    plain = SentencePieceBPE(parse_model_proto(tiny.tiny_spm_model()), merge="python")
    _check_same(jtok, tok, text)
    _check_same(jtok, plain, text)
    norm = WS + text.replace(" ", WS)
    assert tok._bpe_segment(norm) == plain._bpe_segment_py(norm)


def test_tekken_matches_jax_on_samples(tekken_pairs):
    for jtok, tok in tekken_pairs:
        for text in SAMPLES:
            _check_same(jtok, tok, text)
        assert tok.special_by_name == jtok.special_by_name
        assert [tok.id_to_piece(i) for i in range(tok.vocab_size)] == [
            jtok.id_to_piece(i) for i in range(jtok.vocab_size)]


@settings(max_examples=60, deadline=None)
@given(text=TEXT)
def test_tekken_matches_jax_on_drawn_text(tekken_pairs, text):
    for jtok, tok in tekken_pairs:
        _check_same(jtok, tok, text)


def test_load_tokenizer_order_matches_jax(tmp_path):
    (tmp_path / "tokenizer.model.v3").write_bytes(golden.spm_v3_model())
    (tmp_path / "tokenizer.model").write_bytes(tiny.tiny_spm_model())
    assert load_tokenizer(tmp_path).pieces == jax_load_tokenizer(tmp_path).pieces
    (tmp_path / "tekken.json").write_text(json.dumps(tiny.tiny_tekken_cfg()))
    assert isinstance(load_tokenizer(tmp_path), Tekken)
    with pytest.raises(FileNotFoundError):
        load_tokenizer(tmp_path / "nope")


# -- chat templating: every golden of tests/test_chat_golden.py -----------------

M, JM = chat.Message, jax_chat.Message
CALL = {"name": "add", "arguments": '{"a": 1}', "id": "AbCd56789"}
CONVERSATIONS = {
    "instruct": ([("system", "S"), ("user", "hi"), ("assistant", "ok"), ("user", "go")], None),
    "tool_round": ([("user", "hi"), ("assistant", "", [CALL]), ("tool", "2", None, "AbCd56789")],
                   [{"function": {"name": "add", "parameters": {}}}]),
    "tool_history": ([("user", "hi"),
                      ("assistant", "", [{"name": "add", "arguments": {}, "id": "AbCd56789"}]),
                      ("tool", "2", None, "AbCd56789"), ("assistant", "two"), ("user", "go")],
                     None),
    "instruct_short": ([("user", "hi")], None),
    "system_without_user": ([("system", "S"), ("assistant", "partial")], None),
    "tools_json": ([("user", "hello"), ("user", "twice")],
                   [{"type": "function", "function": {"name": "f", "description": "d",
                                                      "parameters": {"x": {"type": "int"}}}}]),
}


def _request(module, turns, tools):
    msgs = []
    for t in turns:
        role, content, calls, call_id = (list(t) + [None, None])[:4]
        msgs.append(module.Message(role, content, tool_calls=calls, tool_call_id=call_id))
    return module.ChatRequest(messages=msgs, tools=tools)


@pytest.fixture(scope="module")
def chat_tokenizers(tekken_pairs):
    spm = _spm_pair(golden.spm_v3_model(), "native")
    return {"spm_v3": spm, "tekken": tekken_pairs[1]}


@pytest.mark.parametrize("tokenizer", ["spm_v3", "tekken"])
@pytest.mark.parametrize("name", list(CONVERSATIONS))
def test_chat_goldens_match_jax(chat_tokenizers, tokenizer, name):
    jtok, tok = chat_tokenizers[tokenizer]
    turns, tools = CONVERSATIONS[name]
    want = jax_chat.encode_chat(jtok, _request(jax_chat, turns, tools))
    assert chat.encode_chat(tok, _request(chat, turns, tools)) == want


@pytest.mark.parametrize("tokenizer", ["spm_v3", "tekken"])
def test_fim_and_bad_call_id_match_jax(chat_tokenizers, tokenizer):
    jtok, tok = chat_tokenizers[tokenizer]
    for prefix, suffix in (("a", "b"), ("def f(x):\n    return", " x + 1\n"), ("", "")):
        assert chat.encode_fim(tok, prefix, suffix) == jax_chat.encode_fim(jtok, prefix, suffix)
    bad = [("user", "hi"), ("assistant", "", [{"name": "f", "arguments": {}, "id": "short"}])]
    with pytest.raises(ValueError, match="9 alphanumeric"):
        chat.encode_chat(tok, _request(chat, bad, None))


def test_chat_multimodal_matches_jax(chat_tokenizers):
    """An image between two text chunks, through the Tekken fixture whose
    specials hold [IMG], [IMG_BREAK] and [IMG_END]."""
    jtok, tok = chat_tokenizers["tekken"]
    kw = dict(hidden_size=64, num_channels=3, image_size=64, patch_size=8, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, image_token_id=10)
    image = np.random.default_rng(0).integers(0, 256, (24, 40, 3), np.uint8)
    content = ["look at", image, "and say"]
    want_ids, want_imgs = jax_chat.encode_chat_multimodal(
        jtok, jax_chat.ChatRequest([jax_chat.Message("user", content)]), JaxVisionArgs(**kw))
    ids, imgs = chat.encode_chat_multimodal(
        tok, chat.ChatRequest([chat.Message("user", content)]), VisionEncoderArgs(**kw))
    assert ids == want_ids and ids.count(10) == (24 // 8) * (40 // 8)
    assert len(imgs) == len(want_imgs) == 1
    np.testing.assert_array_equal(imgs[0], want_imgs[0])


# -- the native build -----------------------------------------------------------


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "g++ -include no/such/header.h")
    with pytest.raises(RuntimeError, match="no/such/header.h"):
        native.build(tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-compiler"))
    with pytest.raises(RuntimeError, match="native BPE build failed"):
        native.build(tmp_path)
    assert not list(tmp_path.iterdir())  # nothing half-written is left


def test_native_build_is_reused(tmp_path):
    so = native.build(tmp_path)
    assert so.is_file() and native.build(tmp_path) == so
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
