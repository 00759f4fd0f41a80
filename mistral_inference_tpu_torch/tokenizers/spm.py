"""SentencePiece-BPE tokenizer: self-contained .model reader + encoder
(counterpart of ``mistral_inference_tpu/tokenizers/spm.py``).

The reference consumes tokenization from the external ``mistral-common``
package (reference: main.py:11-27,41-57), which wraps the sentencepiece C++
library for the v1-v3 ``tokenizer.model`` files (Mistral 7B, Mixtral,
Codestral). Neither package is a dependency here; this module implements
the needed subset directly:

  * a minimal protobuf wire-format parser for ModelProto (pieces = repeated
    field 1 of {piece: string = 1, score: float = 2, type: enum = 3}) — no
    generated code, no protobuf runtime;
  * greedy score-based BPE segmentation (the algorithm sentencepiece uses
    for model_type=BPE: repeatedly merge the adjacent pair whose merged
    piece has the highest score);
  * ▁ (U+2581) whitespace convention with dummy-prefix, and <0xNN>
    byte-fallback for out-of-vocab bytes;
  * decode with byte-piece reassembly.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

WS = "▁"  # ▁

_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _skip(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        n, i = _read_varint(buf, i)
        i += n
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return i


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, _NORMAL
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, i = _read_varint(buf, i)
            piece = buf[i : i + n].decode("utf-8", errors="replace")
            i += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", buf[i : i + 4])
            i += 4
        elif field == 3 and wire == 0:
            ptype, i = _read_varint(buf, i)
        else:
            i = _skip(buf, i, wire)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Returns [(piece, score, type)] in id order."""
    pieces = []
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, i = _read_varint(data, i)
            pieces.append(_parse_piece(data[i : i + n]))
            i += n
        else:
            i = _skip(data, i, wire)
    return pieces


class SentencePieceBPE:
    """Greedy highest-score pair merging over ▁-normalized text."""

    def __init__(self, pieces: List[Tuple[str, float, int]], merge: str = "native"):
        """``merge``: "native" runs the C++ merge loop (built on first use;
        a failed build raises), "python" its plain version."""
        if merge not in ("native", "python"):
            raise ValueError(f"merge must be 'native' or 'python', got {merge!r}")
        self.merge = merge
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = [s for (_, s, _) in pieces]
        self.types = [t for (_, _, t) in pieces]
        self.bos_id = self.piece_to_id.get("<s>", 1)
        self.eos_id = self.piece_to_id.get("</s>", 2)
        self.unk_id = self.piece_to_id.get("<unk>", 0)
        self._byte_ids = {
            i: int(p[3:5], 16)
            for i, (p, _, t) in enumerate(pieces)
            if t == _BYTE and p.startswith("<0x")
        }
        self._byte_piece = {v: k for k, v in self._byte_ids.items()}
        # CONTROL ids are reachable only via explicit special() lookup —
        # sentencepiece never produces control ids from plain text, so user
        # content like "[INST]" must BPE-encode as text, not inject the
        # control token (prompt-injection hardening; parity with
        # sentencepiece / mistral-common). USER_DEFINED pieces DO match
        # verbatim before BPE (the user_defined_symbols behavior).
        self.special_by_name = {
            p: i for i, (p, _, t) in enumerate(pieces) if t in (_CONTROL, _USER_DEFINED)
        }
        self._verbatim = {
            p: i for i, (p, _, t) in enumerate(pieces) if t == _USER_DEFINED
        }

    @classmethod
    def from_file(cls, path: Union[str, Path], merge: str = "native") -> "SentencePieceBPE":
        return cls(parse_model_proto(Path(path).read_bytes()), merge)

    # -- native core --------------------------------------------------------

    _native = None
    _native_lib = None

    def _get_native(self):
        """The C++ merge-loop handle (``native/bpe.cc``), built on first use;
        a failed build raises."""
        if self._native is not None:
            return self._native
        import ctypes

        from mistral_inference_tpu_torch import native

        L = native.lib()
        blobs = [p.encode("utf-8") for (p, _, _) in self.pieces]
        lens = (ctypes.c_int32 * len(blobs))(*[len(b) for b in blobs])
        scores = (ctypes.c_float * len(blobs))(*self.scores)
        self._native_lib = L
        self._native = L.spm_create(b"".join(blobs), lens, scores, len(blobs), self.unk_id)
        return self._native

    def __del__(self):
        if getattr(self, "_native", None) and getattr(self, "_native_lib", None):
            self._native_lib.spm_destroy(self._native)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- encoding -----------------------------------------------------------

    def _bpe_segment(self, text: str) -> List[int]:
        if not text:
            return []
        if self.merge == "python":
            return self._bpe_segment_py(text)
        import ctypes

        h = self._get_native()
        raw = text.encode("utf-8")
        out = (ctypes.c_int32 * max(len(raw), 1))()
        n = self._native_lib.spm_encode(h, raw, len(raw), out)
        return list(out[:n])

    def _bpe_segment_py(self, text: str) -> List[int]:
        """The plain version of the native merge loop: a heap-based merge
        agenda, O(n log n). Always merge the adjacent pair whose
        merged piece has the highest score, leftmost on ties — identical
        output to sentencepiece's symbol-pair agenda."""
        import heapq

        syms: List[str] = list(text)
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        rev = [0] * n  # bumped on merge: stale heap entries self-invalidate

        heap: List[Tuple[float, int, int, int, int]] = []

        def push(i: int, j: int) -> None:
            pid = self.piece_to_id.get(syms[i] + syms[j])
            if pid is not None:
                heapq.heappush(heap, (-self.scores[pid], i, rev[i], j, rev[j]))

        for i in range(n - 1):
            push(i, i + 1)

        while heap:
            _, i, ri, j, rj = heapq.heappop(heap)
            if rev[i] != ri or rev[j] != rj:
                continue  # one side already merged away
            syms[i] = syms[i] + syms[j]
            rev[i] += 1
            rev[j] += 1
            syms[j] = ""
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i], i)
            if nxt[i] != -1:
                push(i, nxt[i])

        out: List[int] = []
        i = 0
        while i != -1:
            s = syms[i]
            pid = self.piece_to_id.get(s)
            if pid is not None:
                out.append(pid)
            else:
                for b in s.encode("utf-8"):
                    out.append(self._byte_piece.get(b, self.unk_id))
            i = nxt[i]
        return out

    def special(self, name: str) -> int:
        """Explicit control/user-defined token lookup (chat.py templating).
        Raises KeyError for unknown names."""
        return self.special_by_name[name]

    def encode(
        self, text: str, bos: bool = True, eos: bool = False
    ) -> List[int]:
        ids: List[int] = []
        # Only USER_DEFINED pieces match verbatim before BPE (the
        # sentencepiece user_defined_symbols behavior): split the text on
        # them (longest first) and BPE only the plain segments. CONTROL
        # strings in raw text are BPE-encoded as plain text.
        for segment, special_id in self._split_special(text):
            if special_id is not None:
                ids.append(special_id)
            elif segment:
                norm = WS + segment.replace(" ", WS)  # add_dummy_prefix
                ids.extend(self._bpe_segment(norm))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def _split_special(self, text: str):
        """Yields (plain_segment, None) and ("", special_id) parts."""
        if not self._verbatim:
            yield text, None
            return
        import re

        if not hasattr(self, "_special_re"):
            pats = sorted(self._verbatim, key=len, reverse=True)
            self._special_re = re.compile("|".join(re.escape(p) for p in pats))
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                yield text[pos : m.start()], None
            yield "", self._verbatim[m.group(0)]
            pos = m.end()
        if pos < len(text):
            yield text[pos:], None

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i in self._byte_ids:
                byte_buf.append(self._byte_ids[i])
                continue
            flush()
            t = self.types[i]
            if t in (_CONTROL, _UNKNOWN):
                continue
            out.append(self.pieces[i][0])
        flush()
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]
