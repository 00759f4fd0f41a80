"""Chat / FIM / tool-call request encoding (counterpart of
``mistral_inference_tpu/tokenizers/chat.py``).

The reference delegates all templating to ``mistral-common``'s
``ChatCompletionRequest`` encoders (reference: main.py:141-159); this is a
compact in-repo equivalent implementing the SAME wire format, re-derived
from the public mistral-common >= 1.3 algorithm (the version the reference
pins, reference: pyproject.toml:30). tests/test_torch_tokenizers.py holds it
to the JAX package's encoder on every golden of tests/test_chat_golden.py.

Request normalization (mistral-common ``InstructRequestNormalizer``):
  * ALL system messages (wherever they appear) are collected into one
    system prompt, joined with "\\n\\n".
  * Consecutive same-role user / assistant messages merge, "\\n\\n"-joined
    (assistant tool_calls lists concatenate).

Instruct layout (v2/v3 control-token style, ``InstructTokenizerV2/V3``):
    <s>[INST]sys\\n\\nuser_last[/INST] — the system prompt attaches to the
    LAST user message (``encode_user_message``: ``if is_last and
    system_prompt``), not the first; v1 (plain-text markers, no control
    tokens) attaches it to the FIRST.
Tool calling (v3 wire format, ``InstructTokenizerV3``):
    * the last user message is preceded by
      [AVAILABLE_TOOLS]{json list of {"type","function":{"name",
      "description","parameters"}}}[/AVAILABLE_TOOLS] (pydantic
      ``Tool.model_dump()`` emits description even when empty)
    * assistant tool calls: [TOOL_CALLS][{"name",...,"arguments",...,
      "id"}]</s> — "id" present only when the call has one (mistral-common
      omits it for the "null" sentinel default)
    * tool results: [TOOL_RESULTS]{"content":...,"call_id":...}[/TOOL_RESULTS]
    * unlike v2, v3 tokenizes the FULL tool interaction history
      (``InstructTokenizerV3.encode_tool_message`` docstring: "history is
      tokenized also"); all JSON payloads use ``json.dumps(...,
      ensure_ascii=False)`` with default separators (", ", ": ").
FIM (Codestral):
    <s>[SUFFIX]{suffix}[PREFIX] {prefix}   → model generates the middle.

Exact token-id goldens for these templates are pinned in
tests/test_chat_golden.py and tests/test_mistral_common_v3.py for both
SPM-v3 and Tekken specials.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class Message:
    role: str  # "system" | "user" | "assistant" | "tool"
    # str for text-only; a list of chunks (str = text, anything else = an
    # image in any form images.decode_image_payload accepts) for multimodal
    # user messages (reference: main.py:77-99 UserMessage(content=chunks)).
    content: Any = ""
    tool_calls: Optional[List[Dict[str, Any]]] = None
    # role == "tool": the id of the call this result answers (v3 wire
    # format carries it in the [TOOL_RESULTS] payload; None → JSON null,
    # matching mistral-common's optional ToolMessage.tool_call_id).
    tool_call_id: Optional[str] = None


@dataclass
class ChatRequest:
    messages: List[Message] = field(default_factory=list)
    tools: Optional[List[Dict[str, Any]]] = None


def _special_ids(tok) -> Dict[str, Optional[int]]:
    def get(name):
        sp = getattr(tok, "special", None)
        try:
            if callable(sp):
                return sp(name)
            if isinstance(sp, dict):
                return sp.get(name)
        except KeyError:
            return None
        return None

    return {name: get(name) for name in (
        "[INST]", "[/INST]", "[AVAILABLE_TOOLS]", "[/AVAILABLE_TOOLS]",
        "[TOOL_RESULTS]", "[/TOOL_RESULTS]", "[TOOL_CALLS]",
        "[PREFIX]", "[SUFFIX]", "[MIDDLE]",
        "[SYSTEM_PROMPT]", "[/SYSTEM_PROMPT]", "[TOOL_CONTENT]",
    )}


def _join_text(a: Any, b: Any) -> Any:
    """Merge two user/assistant contents with "\\n\\n" (normalizer
    aggregation). Chunk lists concatenate around the join."""
    if isinstance(a, str) and isinstance(b, str):
        return a + "\n\n" + b
    la = [a] if isinstance(a, str) else list(a)
    lb = [b] if isinstance(b, str) else list(b)
    return la + ["\n\n"] + lb


def _normalize(
    request: ChatRequest, keep_system: bool = False
) -> Tuple[Optional[str], List[Message]]:
    """mistral-common ``InstructRequestNormalizer``: pull every system
    message (wherever it sits) into one "\\n\\n"-joined system prompt and
    merge consecutive same-role user/assistant messages.

    ``keep_system=True`` (v7 templates): system messages STAY in place as
    their own messages — v7 encodes each as a ``[SYSTEM_PROMPT]`` block at
    its conversation position instead of folding text into a user turn
    (mistral-common ``InstructRequestNormalizerV7``). Consecutive system
    messages still merge "\\n\\n"-joined like other same-role runs."""
    system_parts: List[str] = []
    msgs: List[Message] = []
    for m in request.messages:
        if m.role == "system":
            if m.content:
                if not isinstance(m.content, str):
                    raise ValueError("system content must be text")
                if keep_system:
                    if msgs and msgs[-1].role == "system":
                        msgs[-1] = Message(
                            "system", _join_text(msgs[-1].content, m.content)
                        )
                    else:
                        msgs.append(Message("system", m.content))
                else:
                    system_parts.append(m.content)
            continue
        prev = msgs[-1] if msgs else None
        if prev is not None and prev.role == m.role and m.role in ("user", "assistant"):
            if m.role == "assistant":
                calls = (prev.tool_calls or []) + (m.tool_calls or [])
                content = prev.content
                if m.content:
                    content = (
                        _join_text(prev.content, m.content) if prev.content else m.content
                    )
                msgs[-1] = Message("assistant", content, tool_calls=calls or None)
            else:
                msgs[-1] = Message("user", _join_text(prev.content, m.content))
            continue
        msgs.append(m)
    return ("\n\n".join(system_parts) if system_parts else None), msgs


def _fold_system(content: Any, system_prompt: str) -> Any:
    """Prepend the system prompt to a user message's content. For chunk
    lists the text merges into the first text chunk so BPE merges across
    the join exactly as a single encode would."""
    if isinstance(content, str):
        return system_prompt + "\n\n" + content
    chunks = list(content)
    if chunks and isinstance(chunks[0], str):
        return [system_prompt + "\n\n" + chunks[0]] + chunks[1:]
    return [system_prompt + "\n\n"] + chunks


def encode_chat(tok, request: ChatRequest) -> List[int]:
    """Token ids for a text-only chat request, ending after the final
    ``[/INST]`` so the model generates the assistant reply."""
    ids, _ = encode_chat_multimodal(tok, request, vargs=None)
    return ids


def encode_chat_multimodal(tok, request: ChatRequest, vargs=None):
    """(token ids, preprocessed image arrays) for a chat request whose user
    messages may carry image chunks. ``vargs`` (VisionEncoderArgs) is
    required when any images are present — it fixes patch size / resize
    targets and hence the [IMG] grid layout (reference: main.py:150-159
    encode_chat_completion → tokens + images)."""
    sp = _special_ids(tok)
    use_control = sp["[INST]"] is not None
    # v7 template (Small 3.1, Large 2.x, Pixtral-Large — mistral-common
    # ``InstructTokenizerV7``, pinned by the reference via
    # mistral_common >= 1.5.4, reference pyproject.toml:30): detected by the
    # [SYSTEM_PROMPT] control token in the tokenizer's special table. The
    # system prompt becomes its own ``[SYSTEM_PROMPT]…[/SYSTEM_PROMPT]``
    # block at its conversation position (the public Large-2411 model-card
    # template: ``<s>[SYSTEM_PROMPT]…[/SYSTEM_PROMPT][INST]…[/INST]``)
    # instead of folding into the last user message, and tool results are
    # encoded raw — [TOOL_RESULTS]{id}[TOOL_CONTENT]{content}[/TOOL_RESULTS]
    # — instead of v3's JSON {"content","call_id"} wrapper.
    v7 = use_control and sp["[SYSTEM_PROMPT]"] is not None
    images: List[Any] = []

    def _as_text(content) -> str:
        if not isinstance(content, str):
            raise ValueError("chunked content is allowed in user messages only")
        return content

    system_prompt, msgs = _normalize(request, keep_system=v7)

    # No user message to carry the system prompt (assistant-continuation or
    # system-only requests): synthesize a leading user turn from it.
    # mistral-common would REJECT such requests upstream (the request
    # validator wants the conversation to end on a user/tool turn); this
    # leniency keeps the instructions in the token stream instead of
    # silently dropping them. (v7 needs no such fallback — its system
    # block stands alone in the token stream.)
    if system_prompt and not any(m.role == "user" for m in msgs):
        msgs.insert(0, Message("user", system_prompt))
        system_prompt = None

    # index of last (and first) user message: tools attach in front of the
    # last one; the system prompt folds into the last (v2/v3) or first (v1).
    user_idx = [i for i, m in enumerate(msgs) if m.role == "user"]
    last_user = user_idx[-1] if user_idx else -1
    first_user = user_idx[0] if user_idx else -1
    sys_target = last_user if use_control else first_user

    ids: List[int] = [tok.bos_id]

    def text(s: str) -> List[int]:
        # Content is encoded verbatim: SPM's dummy-prefix supplies the
        # word-initial ▁ itself; an explicit leading space would double it.
        return tok.encode(s, bos=False, eos=False)

    def user_content(content) -> List[int]:
        if isinstance(content, str):
            return text(content)
        from mistral_inference_tpu_torch.images import encode_user_content  # noqa: PLC0415

        if vargs is None:
            raise ValueError("image chunks need a model with a vision encoder")
        cids, cimgs = encode_user_content(tok, vargs, content)
        images.extend(cimgs)
        return cids

    for i, m in enumerate(msgs):
        if m.role == "system":
            # v7 only (_normalize keeps system messages only for v7):
            # InstructTokenizerV7.encode_system_message — content between
            # the dedicated control tokens, no joins, no folding.
            ids += [sp["[SYSTEM_PROMPT]"]]
            ids += text(_as_text(m.content))
            ids += [sp["[/SYSTEM_PROMPT]"]]
        elif m.role == "user":
            content = m.content
            if system_prompt and i == sys_target:
                content = _fold_system(content, system_prompt)
            if request.tools and i == last_user:
                if not use_control:
                    raise ValueError(
                        "tool calling needs a v2/v3 control-token tokenizer"
                    )
                tools_json = json.dumps(_wrap_tools(request.tools),
                                        ensure_ascii=False)
                ids += [sp["[AVAILABLE_TOOLS]"]]
                ids += text(tools_json)
                ids += [sp["[/AVAILABLE_TOOLS]"]]
            if use_control:
                ids += [sp["[INST]"]] + user_content(content) + [sp["[/INST]"]]
            else:
                ids += text(f"[INST] {_as_text(content)} [/INST]")
        elif m.role == "assistant":
            if m.tool_calls:
                # v3 tokenizes tool-call history from EVERY turn (v2
                # dropped pre-last-user calls; no shipping checkpoint uses
                # the v2 tool format).
                if not use_control:
                    raise ValueError(
                        "tool calling needs a v2/v3 control-token tokenizer"
                    )
                calls_json = json.dumps(
                    [_prepare_tool_call(c) for c in m.tool_calls],
                    ensure_ascii=False,
                )
                ids += [sp["[TOOL_CALLS]"]] + text(calls_json)
            else:
                ids += text(_as_text(m.content))
            ids += [tok.eos_id]
        elif m.role == "tool":
            if not use_control:
                raise ValueError(
                    "tool results need a v2/v3 control-token tokenizer"
                )
            if v7:
                # InstructTokenizerV7.encode_tool_message: the call id and
                # the content are tokenized directly (no JSON wrapper),
                # separated by the [TOOL_CONTENT] control token. v7
                # requires the id — it is the only structure delimiting
                # the result on the wire.
                cid = _valid_call_id(m.tool_call_id)
                if cid is None:
                    raise ValueError("v7 tool results require tool_call_id")
                content = m.content
                if not isinstance(content, str):
                    content = json.dumps(content, ensure_ascii=False)
                ids += [sp["[TOOL_RESULTS]"]] + text(cid)
                ids += [sp["[TOOL_CONTENT]"]] + text(content)
                ids += [sp["[/TOOL_RESULTS]"]]
            else:
                payload = json.dumps({
                    "content": _maybe_json(m.content),
                    "call_id": _valid_call_id(m.tool_call_id),
                }, ensure_ascii=False)
                ids += (
                    [sp["[TOOL_RESULTS]"]] + text(payload)
                    + [sp["[/TOOL_RESULTS]"]]
                )
        else:
            raise ValueError(f"unsupported role {m.role}")
    return ids, images


_ID_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def _valid_call_id(call_id: Optional[str]) -> Optional[str]:
    """v3 tool-call ids are exactly 9 alphanumeric chars (mistral-common's
    finetuning-mode validator). Absent ids pass through as None — the
    TOOL_CALLS payload then omits the key and the TOOL_RESULTS payload
    carries JSON null, exactly like mistral-common's "null" sentinel
    default; invalid ids raise rather than silently producing token
    sequences the model never saw."""
    if call_id is None or call_id == "null":
        return None
    ok = len(call_id) == 9 and all(c in _ID_ALPHABET for c in call_id)
    if not ok:
        raise ValueError(
            f"tool call id must be 9 alphanumeric chars, got {call_id!r}"
        )
    return call_id


def _maybe_json(x: Any) -> Any:
    """mistral-common parses JSON-looking string payloads into objects
    before re-serializing them inside the wire payload."""
    if isinstance(x, str):
        try:
            return json.loads(x)
        except (ValueError, TypeError):
            return x
    return x


def _prepare_tool_call(call: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize one assistant tool call to the v3 payload shape
    {"name", "arguments" (object)[, "id" (9-char)]}. Accepts both the flat
    form and the OpenAI-style {"function": {...}, "id": ...} nesting.
    mistral-common ``InstructTokenizerV3._prepare_function_call``: the id
    key is emitted only when the call carries a real id."""
    fn = call.get("function", call)
    args = _maybe_json(fn.get("arguments", {}))
    out = {"name": fn["name"], "arguments": args}
    cid = _valid_call_id(call.get("id"))
    if cid is not None:
        out["id"] = cid
    return out


def _wrap_tools(tools: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """[AVAILABLE_TOOLS] serializes full Tool objects via pydantic
    ``model_dump()``: {"type": "function", "function": {"name",
    "description", "parameters"}} — description is always present (the
    model default is ""), in declaration order."""
    out = []
    for t in tools:
        fn = t["function"] if "function" in t else t
        out.append({
            "type": t.get("type", "function"),
            "function": {
                "name": fn["name"],
                "description": fn.get("description", ""),
                "parameters": fn.get("parameters", {}),
            },
        })
    return out


def encode_fim(tok, prefix: str, suffix: str = "") -> List[int]:
    """Fill-in-the-middle prompt (Codestral): generation continues the
    middle after the prefix."""
    sp = _special_ids(tok)
    if sp["[SUFFIX]"] is None or sp["[PREFIX]"] is None:
        raise ValueError("tokenizer has no FIM control tokens")
    ids = [tok.bos_id, sp["[SUFFIX]"]]
    ids += tok.encode(suffix, bos=False, eos=False)
    ids += [sp["[PREFIX]"]]
    ids += tok.encode(prefix, bos=False, eos=False)
    return ids
