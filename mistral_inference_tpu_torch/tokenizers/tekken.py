"""Tekken tokenizer — Mistral's tiktoken-style byte-BPE (tekken.json)
(counterpart of ``mistral_inference_tpu/tokenizers/tekken.py``).

Used by Nemo 12B, Pixtral, Small 3.1, Large 2. The reference gets this via
``mistral-common`` (reference: main.py:41-57 autodiscovers ``tekken.json``);
here the loader is self-contained on top of the ``tiktoken`` core.

Format: JSON with
  config: {pattern, default_vocab_size, default_num_special_tokens, version}
  vocab:  [{rank, token_bytes (base64), token_str?}, ...]
  special_tokens (v7+): [{rank, token_str, is_control}, ...]
Token id space: special tokens occupy [0, num_special); BPE ranks are offset
by num_special. Earlier versions hardcode the <unk>/<s>/</s>/[INST]/[/INST]…
special layout, reproduced below.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

# Pre-v7 fixed special-token layout (mistral-common SpecialTokens order).
DEFAULT_SPECIALS = [
    "<unk>",
    "<s>",
    "</s>",
    "[INST]",
    "[/INST]",
    "[AVAILABLE_TOOLS]",
    "[/AVAILABLE_TOOLS]",
    "[TOOL_RESULTS]",
    "[/TOOL_RESULTS]",
    "[TOOL_CALLS]",
    "[IMG]",
    "<pad>",
    "[IMG_BREAK]",
    "[IMG_END]",
    "[PREFIX]",
    "[MIDDLE]",
    "[SUFFIX]",
]


class Tekken:
    def __init__(self, cfg: dict):
        import tiktoken

        config = cfg["config"]
        self.version = config.get("version", "v3")
        self.num_special = config.get("default_num_special_tokens", 1000)
        vocab_size = config.get("default_vocab_size")

        ranks: Dict[bytes, int] = {}
        for item in cfg["vocab"]:
            ranks[base64.b64decode(item["token_bytes"])] = item["rank"]
        if vocab_size is not None:
            max_rank = vocab_size - self.num_special
            ranks = {b: r for b, r in ranks.items() if r < max_rank}

        self._enc = tiktoken.Encoding(
            name="tekken",
            pat_str=config["pattern"],
            mergeable_ranks=ranks,
            special_tokens={},
        )
        self.vocab_size = (vocab_size or (len(ranks) + self.num_special))

        specials = cfg.get("special_tokens")
        if specials:
            self.special_by_name = {
                s["token_str"]: s["rank"] for s in specials if s.get("token_str")
            }
        else:
            self.special_by_name = {t: i for i, t in enumerate(DEFAULT_SPECIALS)}

        self.bos_id = self.special_by_name.get("<s>", 1)
        self.eos_id = self.special_by_name.get("</s>", 2)
        self.unk_id = self.special_by_name.get("<unk>", 0)
        self.pad_id = self.special_by_name.get("<pad>", 11)

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "Tekken":
        with open(path) as f:
            return cls(json.load(f))

    def special(self, name: str) -> int:
        return self.special_by_name[name]

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [t + self.num_special for t in self._enc.encode_ordinary(text)]
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytearray()
        for i in ids:
            if i < self.num_special:
                continue  # controls don't render
            data += self._enc.decode_single_token_bytes(i - self.num_special)
        return data.decode("utf-8", errors="replace")

    def id_to_piece(self, i: int) -> str:
        if i < self.num_special:
            for name, r in self.special_by_name.items():
                if r == i:
                    return name
            return f"<special:{i}>"
        return self._enc.decode_single_token_bytes(i - self.num_special).decode(
            "utf-8", errors="replace"
        )
