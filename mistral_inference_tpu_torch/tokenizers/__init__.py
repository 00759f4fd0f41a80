"""Tokenizer subsystem: SentencePiece-BPE (v1-v3 .model files), Tekken
(tekken.json), chat/FIM/tool templating, and folder autodiscovery
(counterpart of ``mistral_inference_tpu/tokenizers``).

Replaces the reference's external ``mistral-common`` dependency for the
paths this framework needs (reference: main.py:41-57 autodiscovery order)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from mistral_inference_tpu_torch.tokenizers.chat import (  # noqa: F401
    ChatRequest,
    Message,
    encode_chat,
    encode_fim,
)
from mistral_inference_tpu_torch.tokenizers.spm import SentencePieceBPE  # noqa: F401
from mistral_inference_tpu_torch.tokenizers.tekken import Tekken  # noqa: F401

# Discovery order mirrors the reference: newest spm version first, then
# tekken (reference: main.py:41-57 asserts exactly one tokenizer present).
_SPM_NAMES = ("tokenizer.model.v7", "tokenizer.model.v3", "tokenizer.model.v2", "tokenizer.model.v1", "tokenizer.model")


def load_tokenizer(folder: Union[str, Path]):
    folder = Path(folder)
    tekken = folder / "tekken.json"
    if tekken.is_file():
        return Tekken.from_file(tekken)
    for name in _SPM_NAMES:
        p = folder / name
        if p.is_file():
            return SentencePieceBPE.from_file(p)
    raise FileNotFoundError(f"no tokenizer (tekken.json or tokenizer.model*) in {folder}")
