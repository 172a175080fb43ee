"""Tokenization (a copy of the JAX package's ``utils/tokens.py``).

- :class:`HFTokenizer` wraps a ``tokenizer.json`` (HuggingFace
  ``tokenizers`` library) from a local model directory.
- :class:`ByteTokenizer` is the deterministic byte-level fallback (256
  bytes + specials) used when no tokenizer file exists (random-init
  serving). It produces real token streams with the same API.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

# Special token names shared by both tokenizers. The byte tokenizer assigns
# them ids above 255; HF tokenizers resolve them from their vocab when present.
SPECIAL_TOKENS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|eot_id|>",
    "<|pad|>",
]


class ByteTokenizer:
    """UTF-8 byte tokenizer with Llama-3-style special tokens."""

    def __init__(self) -> None:
        self._special_to_id = {tok: 256 + i for i, tok in enumerate(SPECIAL_TOKENS)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.vocab_size = 256 + len(SPECIAL_TOKENS)
        self.bos_id = self._special_to_id["<|begin_of_text|>"]
        self.eos_id = self._special_to_id["<|end_of_text|>"]
        self.eot_id = self._special_to_id["<|eot_id|>"]
        self.pad_id = self._special_to_id["<|pad|>"]

    def token_to_id(self, token: str) -> Optional[int]:
        return self._special_to_id.get(token)

    def encode(self, text: str, allow_special: bool = True) -> list[int]:
        if not allow_special:
            return list(text.encode("utf-8"))
        ids: list[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for tok, tid in self._special_to_id.items():
                    if text.startswith(tok, i):
                        ids.append(tid)
                        i += len(tok)
                        matched = True
                        break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: list[str] = []
        buf = bytearray()
        for tid in ids:
            if tid < 256:
                buf.append(tid)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(self._id_to_special.get(tid, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    # Single-token byte decode used by guided decoding to walk candidates.
    def id_to_bytes(self, tid: int) -> bytes:
        if tid < 256:
            return bytes([tid])
        return self._id_to_special.get(tid, "").encode("utf-8")

    @property
    def special_ids(self) -> frozenset[int]:
        """Control tokens — never admissible as grammar *content* (their
        id_to_bytes expansion is markup like ``<|eot_id|>``, not text)."""
        return frozenset(self._id_to_special)


@lru_cache(maxsize=1)
def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode: vocab char -> raw byte.

    Byte-level BPE tokenizers (GPT-2, Llama-3, Qwen2) store each raw byte
    as a printable unicode char in vocab strings; mapping back recovers the
    exact byte sequence of a single token, even when it is half of a
    multi-byte UTF-8 character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class HFTokenizer:
    """Wraps a local ``tokenizer.json`` via the HuggingFace ``tokenizers`` lib."""

    def __init__(self, path: str | Path):
        from tokenizers import Tokenizer as _Tok  # deferred heavy import

        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        self._tok = _Tok.from_file(str(p))
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = self._find_id(["<|begin_of_text|>", "<s>", "[CLS]"])
        self.eos_id = self._find_id(
            ["<|end_of_text|>", "<|endoftext|>", "</s>", "[SEP]"])
        # End-of-turn: Llama-3 <|eot_id|>, ChatML (Qwen2) <|im_end|>.
        self.eot_id = (self._find_id(["<|eot_id|>", "<|im_end|>"])
                       or self.eos_id)
        self.pad_id = self._find_id(["<|pad|>", "<pad>", "[PAD]"]) or 0

    def _find_id(self, candidates: list[str]) -> Optional[int]:
        for c in candidates:
            tid = self._tok.token_to_id(c)
            if tid is not None:
                return tid
        return None

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def encode(self, text: str, allow_special: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=False)

    # Single-token byte decode used by guided decoding to walk candidates
    # and by streaming's incremental UTF-8 decoder. Byte-level BPE vocab
    # strings (Llama-3/GPT-2 style) map char-by-char through the inverted
    # bytes_to_unicode table, so a multi-byte character SPLIT ACROSS TOKENS
    # round-trips exactly; decode([tid]) would yield U+FFFD per half-token.
    def id_to_bytes(self, tid: int) -> bytes:
        token = self._tok.id_to_token(tid)
        if token is None:
            return b""
        dec = _gpt2_byte_decoder()
        if all(ch in dec for ch in token):
            return bytes(dec[ch] for ch in token)
        # Non-byte-level vocab (sentencepiece "▁" style) or special token.
        return self._tok.decode([tid], skip_special_tokens=False).encode("utf-8")

    @property
    def special_ids(self) -> frozenset[int]:
        """ALL added/control tokens (Llama-3 ships ~250 reserved specials) —
        none may be admitted as grammar content: their byte expansion is
        markup like ``<|start_header_id|>`` that a string automaton would
        otherwise accept."""
        try:
            ids = set(self._tok.get_added_tokens_decoder())
        except AttributeError:  # older `tokenizers` releases
            ids = set()
        for tid in (self.bos_id, self.eos_id, self.eot_id, self.pad_id):
            if tid is not None:
                ids.add(tid)
        return frozenset(ids)


Tokenizer = ByteTokenizer | HFTokenizer
