"""The port's HTTP API (``server/api.py``) on a real socket over the port's
``Engine``, tiny models in fp32 on the CPU: the cases of
tests/test_server.py, each greedy completion held to the port's
``generate()`` alone, and a Pixtral image chat request whose tokens equal
``generate(images=...)``."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mistral_inference_tpu_torch.args import TransformerArgs, VisionEncoderArgs
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.server.api import Server, _make_handler
from mistral_inference_tpu_torch.server.engine import Engine
from mistral_inference_tpu_torch.tokenizers import chat


class DummyTok:
    bos_id, eos_id = 1, 2

    def encode(self, text, bos=True, eos=False):
        ids = [3 + (ord(c) % 100) for c in text][:16] or [5]
        return ([self.bos_id] if bos else []) + ids

    def decode(self, ids):
        return " ".join(map(str, ids))


class MMTok(DummyTok):
    """The multimodal special layout of the Tekken convention."""

    SPECIALS = {"[INST]": 3, "[/INST]": 4, "[IMG]": 10, "[IMG_BREAK]": 12, "[IMG_END]": 13}

    def special(self, name):
        return self.SPECIALS[name]

    def encode(self, text, bos=True, eos=False):
        return ([self.bos_id] if bos else []) + [20 + (ord(c) % 100) for c in text]


def tiny_model(vision=None, seed=42) -> Transformer:
    args = TransformerArgs(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4,
                           n_kv_heads=2, norm_eps=1e-5, vocab_size=512, rope_theta=1e4,
                           vision_encoder=vision)
    return Transformer.random(args, dtype=torch.float32, seed=seed, device="cpu")


VISION = VisionEncoderArgs(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
                           intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                           image_token_id=10)


def _serve(model, tok, **engine_kw):
    eng = Engine(model, batch_size=2, max_seq_len=engine_kw.pop("max_seq_len", 64),
                 temperature=0.0, decode_block=4, **engine_kw)
    srv = Server(eng, tok)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    srv.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def server(model):
    srv, httpd, url = _serve(model, DummyTok())
    yield url
    httpd.shutdown()
    srv.stop()


def _post(url, path, obj):
    req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _alone(model, ids, n, **kw):
    return generate([ids], model, max_tokens=n, temperature=0.0, **kw)


def test_health(server):
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and "metrics" in body


def test_completions(server, model):
    out = _post(server, "/v1/completions", {"prompt": "hello", "max_tokens": 5})
    assert out["choices"][0]["tokens"] == _alone(model, DummyTok().encode("hello"), 5)[0][0]


def test_completions_token_ids(server, model):
    out = _post(server, "/v1/completions", {"prompt": [1, 5, 9], "max_tokens": 4})
    assert out["choices"][0]["tokens"] == _alone(model, [1, 5, 9], 4)[0][0]


def test_concurrent_requests(server, model):
    results = {}

    def go(i):
        results[i] = _post(server, "/v1/completions", {"prompt": [1, 5 + i, 9], "max_tokens": 4})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == [0, 1, 2, 3]
    for i, out in results.items():
        assert out["choices"][0]["tokens"] == _alone(model, [1, 5 + i, 9], 4)[0][0]


def test_streaming_completions(server, model):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": [1, 5, 9], "max_tokens": 4, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        body = r.read().decode()
    events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    assert [json.loads(e)["token"] for e in events[:-1]] == _alone(model, [1, 5, 9], 4)[0][0]


def test_chat_completions_endpoint(server):
    out = _post(server, "/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3})
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)


def test_per_request_temperature_endpoint(server):
    out = _post(server, "/v1/completions",
                {"prompt": [1, 5, 9], "max_tokens": 4, "temperature": 0.9})
    assert len(out["choices"][0]["tokens"]) == 4


def test_completions_logprobs(server, model):
    out = _post(server, "/v1/completions",
                {"prompt": [1, 5, 9, 13], "max_tokens": 4, "logprobs": True})
    lp = out["choices"][0]["logprobs"]
    want = _alone(model, [1, 5, 9, 13], 4)[1][0]
    np.testing.assert_allclose(lp["prompt_logprobs"] + lp["token_logprobs"], want,
                               atol=1e-5, rtol=0)
    assert len(lp["prompt_logprobs"]) == 3 and len(lp["token_logprobs"]) == 4


def test_completions_top_p_and_stop(server):
    """Per-request top_p (a tiny nucleus is greedy) and multi-token stop
    strings (text truncation)."""
    greedy = _post(server, "/v1/completions", {"prompt": "stopx", "max_tokens": 6})
    tiny = _post(server, "/v1/completions", {"prompt": "stopx", "max_tokens": 6,
                                             "temperature": 0.9, "top_p": 1e-6})
    assert tiny["choices"][0]["tokens"] == greedy["choices"][0]["tokens"]
    full = greedy["choices"][0]["text"]
    frag = full.split(" ")[2]
    out = _post(server, "/v1/completions", {"prompt": "stopx", "max_tokens": 6,
                                            "stop": " " + frag})
    assert out["choices"][0]["text"] == full[: full.find(" " + frag)]


def test_refused_requests_answer_400(server):
    for path, body in (("/v1/completions", {"prompt": [1, 5], "max_tokens": 100}),
                       ("/v1/chat/completions",
                        {"messages": [{"role": "user", "content": [{"type": "video"}]}]})):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, path, body)
        assert e.value.code == 400


def test_completions_speculative_engine(model):
    """Speculative serving waits for a later slice of the port."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        _serve(model, DummyTok(), draft_model="lookup")


def _png(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("payload", ["nested_list", "png"])
def test_chat_completion_with_image(payload):
    """An image chat request over HTTP gives the tokens of the port's
    generate(images=...) on the same request."""
    model = tiny_model(VISION, seed=4)
    tok = MMTok()
    arr = np.random.default_rng(0).integers(0, 256, (16, 24, 3), np.uint8)
    image = ({"type": "image", "image": arr.tolist()} if payload == "nested_list"
             else {"type": "image_url", "image_url": {"url": _png(arr)}})
    srv, httpd, url = _serve(model, tok, max_seq_len=96)
    try:
        out = _post(url, "/v1/chat/completions", {
            "messages": [{"role": "user",
                          "content": [{"type": "text", "text": "what is this?"}, image]}],
            "max_tokens": 6})
        text = _post(url, "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "and this?"}], "max_tokens": 6})
    finally:
        httpd.shutdown()
        srv.stop()
    ids, images = chat.encode_chat_multimodal(
        tok, chat.ChatRequest([chat.Message("user", ["what is this?", arr])]), VISION)
    assert ids.count(10) == 6 and len(images) == 1
    want = _alone(model, ids, 6, images=[images])[0][0]
    assert out["choices"][0]["message"]["content"] == tok.decode(want)
    want = _alone(model, chat.encode_chat(tok, chat.ChatRequest([chat.Message("user", "and this?")])),
                  6)[0][0]
    assert text["choices"][0]["message"]["content"] == tok.decode(want)
