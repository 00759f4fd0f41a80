"""HTTP serving layer — OpenAI-compatible completions API on the
continuous-batching engine (counterpart of
``mistral_inference_tpu/server/api.py``).

The reference's deploy story is a Docker image that serves via an external
vLLM api_server (reference: deploy/Dockerfile:18, entrypoint.sh:11 — none
of the reference's own code runs in serving). Here serving is first-party:
stdlib ThreadingHTTPServer front-end, one background device thread stepping
the Engine, per-request completion futures.

Endpoints:
  POST /v1/completions       {"prompt": str | [int], "max_tokens", "temperature"}
  POST /v1/chat/completions  {"messages": [{role, content}], ...}
  GET  /health               liveness + metrics
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from mistral_inference_tpu_torch.server.engine import Engine
from mistral_inference_tpu_torch.tokenizers.chat import (
    ChatRequest,
    Message,
    encode_chat,
    encode_chat_multimodal,
)
from mistral_inference_tpu_torch.utils.profiling import METRICS


def _normalize_content(content):
    """OpenAI-style message content → chat.Message content: a plain string
    passes through; a chunk list maps {"type": "text"} → str and
    {"type": "image_url" | "image"} → a decoded image object (base64 data
    URL, local path, or nested array — no network fetch)."""
    if isinstance(content, str):
        return content
    from mistral_inference_tpu_torch.images import decode_image_payload

    chunks = []
    for c in content:
        if isinstance(c, str):
            chunks.append(c)
        elif c.get("type") == "text":
            chunks.append(c.get("text", ""))
        elif c.get("type") == "image_url":
            url = c["image_url"]
            if isinstance(url, dict):
                url = url["url"]
            chunks.append(decode_image_payload(url))
        elif c.get("type") == "image":
            chunks.append(decode_image_payload(c["image"]))
        else:
            raise ValueError(f"unsupported content chunk {c.get('type')}")
    return chunks


class Server:
    def __init__(self, engine: Engine, tokenizer) -> None:
        self.engine = engine
        self.tok = tokenizer
        self._futures: Dict[int, Future] = {}
        self._streams: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.healthy = True
        self._thread = threading.Thread(target=self._device_loop, daemon=True)

    # -- request path -------------------------------------------------------

    def _stop_ids(self, stop) -> tuple:
        """Single-token stop strings become engine-level stop ids (exact,
        zero overhead); multi-token ones are text-matched by the HTTP layer
        (truncate + cancel)."""
        ids = []
        for sx in stop or ():
            enc = self.tok.encode(sx, bos=False, eos=False)
            if len(enc) == 1:
                ids.append(enc[0])
        return tuple(ids)

    def submit(
        self, prompt_ids, max_tokens: int, temperature=None, images=(),
        want_logprobs: bool = False, top_p=None, stop=(),
    ) -> Future:
        fut: Future = Future()
        with self._lock:
            rid = self.engine.submit(
                prompt_ids, max_tokens=max_tokens, temperature=temperature,
                images=images, want_logprobs=want_logprobs, top_p=top_p,
                stop_ids=self._stop_ids(stop),
            )
            self._futures[rid] = fut
        return fut

    def submit_stream(
        self, prompt_ids, max_tokens: int, temperature=None, images=(),
        top_p=None, stop=(),
    ):
        """Returns (queue, request_id): the queue yields (token, finished)
        tuples as the engine emits them; a device error enqueues
        (exception, True)."""
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            rid = self.engine.submit(
                prompt_ids, max_tokens=max_tokens, temperature=temperature,
                images=images, top_p=top_p, stop_ids=self._stop_ids(stop),
            )
            self._streams[rid] = q
        return q, rid

    def cancel(self, request_id: int) -> None:
        with self._lock:
            self.engine.cancel(request_id)
            self._streams.pop(request_id, None)

    def drop_stream(self, q: "queue.Queue") -> None:
        """Unregister a stream queue after client disconnect/timeout; the
        engine keeps decoding the slot but tokens are no longer enqueued."""
        with self._lock:
            for rid, sq in list(self._streams.items()):
                if sq is q:
                    self._streams.pop(rid)

    def _device_loop(self) -> None:
        import logging

        while not self._stop.is_set():
            with self._lock:
                has_work = self.engine.has_work
            if not has_work:
                self._stop.wait(0.005)
                continue
            try:
                with self._lock:
                    events = self.engine.step()
                    for ev in events:
                        METRICS.inc("tokens_generated")
                        if ev.request_id in self._streams:
                            err = (
                                self.engine._request(ev.request_id).error
                                if ev.finished else None
                            )
                            self._streams[ev.request_id].put(
                                (RuntimeError(err), True) if err
                                else (ev.token, ev.finished)
                            )
                            if ev.finished:
                                self._streams.pop(ev.request_id)
                        if ev.finished and ev.request_id in self._futures:
                            req = self.engine._request(ev.request_id)
                            self._futures.pop(ev.request_id).set_result(req)
            except Exception as e:  # device error: fail pending work loudly
                logging.exception("serving device loop failed")
                METRICS.inc("device_errors")
                self.healthy = False
                with self._lock:
                    for fut in self._futures.values():
                        if not fut.done():
                            fut.set_exception(e)
                    self._futures.clear()
                    for q in self._streams.values():
                        q.put((e, True))
                    self._streams.clear()
                self._stop.set()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # -- http ---------------------------------------------------------------

    def serve(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        self.start()
        server = ThreadingHTTPServer((host, port), _make_handler(self))
        try:
            server.serve_forever()
        finally:
            self.stop()


def _make_handler(srv: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: Any) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_response(self, ids, max_tokens, temp, images=(),
                             top_p=None, stop=()):
            """Server-sent events: one `data:` line per generated token.
            Client disconnects (BrokenPipe/OSError) and stalled engines
            (queue.Empty) must not leak the stream registration or skip the
            terminal [DONE] event. Multi-token stop strings are
            text-matched on the decoded stream: the request is cancelled
            and the stream ends at the match."""
            q, rid = srv.submit_stream(
                ids, max_tokens, temperature=temp, images=images,
                top_p=top_p, stop=stop,
            )
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            text_so_far = ""
            try:
                while True:
                    tok, finished = q.get(timeout=600)
                    if isinstance(tok, Exception):
                        payload = {"error": f"{type(tok).__name__}: {tok}"[:300]}
                        self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                        break
                    piece = srv.tok.decode([tok])
                    if stop:
                        text_so_far += piece
                        if any(sx in text_so_far for sx in stop):
                            srv.cancel(rid)
                            break
                    payload = {"token": tok, "text": piece}
                    self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()
                    if finished:
                        break
                self.wfile.write(b"data: [DONE]\n\n")
            except queue.Empty:
                try:
                    self.wfile.write(b'data: {"error": "stream timeout"}\n\n')
                    self.wfile.write(b"data: [DONE]\n\n")
                except OSError:
                    pass
                srv.drop_stream(q)
            except OSError:
                # client went away mid-stream: unregister so the device loop
                # stops feeding a dead queue
                srv.drop_stream(q)

        def do_GET(self):
            if self.path == "/health":
                code = 200 if srv.healthy else 503
                self._json(
                    code,
                    {
                        "status": "ok" if srv.healthy else "device_error",
                        "metrics": json.loads(METRICS.dump()),
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})
            max_tokens = int(req.get("max_tokens", 128))

            images = []
            if self.path == "/v1/completions":
                prompt = req.get("prompt", "")
                ids = (
                    list(map(int, prompt))
                    if isinstance(prompt, list)
                    else srv.tok.encode(prompt, bos=True, eos=False)
                )
            elif self.path == "/v1/chat/completions":
                try:
                    msgs = [
                        Message(m["role"], _normalize_content(m.get("content", "")))
                        for m in req.get("messages", [])
                    ]
                    vargs = getattr(srv.engine.model.args, "vision_encoder", None)
                    ids, images = encode_chat_multimodal(
                        srv.tok, ChatRequest(messages=msgs), vargs
                    )
                except (ValueError, TypeError) as e:  # a malformed request
                    return self._json(400, {"error": str(e)[:300]})
            else:
                return self._json(404, {"error": "not found"})

            METRICS.inc("requests")
            temp = req.get("temperature")
            top_p = req.get("top_p")
            stop = req.get("stop") or ()
            if isinstance(stop, str):
                stop = (stop,)

            try:
                if req.get("stream"):
                    return self._stream_response(
                        ids, max_tokens, temp, images, top_p=top_p, stop=stop
                    )
                fut = srv.submit(
                    ids, max_tokens, temperature=temp, images=images,
                    want_logprobs=bool(req.get("logprobs")),
                    top_p=top_p, stop=stop,
                )
            except ValueError as e:  # the engine refused the request
                return self._json(400, {"error": str(e)[:300]})
            try:
                result = fut.result(timeout=600)
            except Exception as e:
                return self._json(500, {"error": f"{type(e).__name__}: {e}"[:300]})
            if result.error:  # per-request numerical failure (engine)
                return self._json(500, {"error": result.error})
            tokens = result.generated
            text = srv.tok.decode(tokens)
            # Multi-token stop strings: truncate the completion text at the
            # earliest match (single-token stops already ended generation).
            for sx in stop:
                i = text.find(sx)
                if i >= 0:
                    text = text[:i]
            if self.path == "/v1/completions":
                choice = {"text": text, "tokens": tokens}
                if req.get("logprobs"):
                    choice["logprobs"] = {
                        "prompt_logprobs": result.prompt_logprobs,
                        "token_logprobs": result.gen_logprobs,
                    }
                self._json(200, {"choices": [choice]})
            else:
                choice = {"message": {"role": "assistant", "content": text}}
                if req.get("logprobs"):
                    choice["logprobs"] = {"token_logprobs": result.gen_logprobs}
                self._json(200, {"choices": [choice]})

    return Handler
