"""Dual-mode BPE tokenizer built from GGUF vocab metadata.

Capability parity with the reference tokenizer (src/inference/tokenizer.cpp):
auto-detects GPT-2 byte-level BPE (Llama 3) vs SentencePiece (Llama 1/2) by
the presence of the GPT-2-encoded space token 'Ġ' (tokenizer.cpp:76-85),
greedy longest-match seeding + score-driven merges (tokenizer.cpp:101-217),
byte-fallback tokens, and control-token-dropping decode.

Beyond the reference: when `tokenizer.ggml.merges` is present (standard for
Llama-3 GGUFs), encoding is UPSTREAM-EXACT byte-level BPE — GPT-2/Llama-3
regex pretokenization, single-character seeding, lowest-rank-first merges —
where the reference (and our fallback path, used when only scores exist)
approximates with greedy longest-match seeding + score-driven merges
(tokenizer.cpp:101-217), which can pick different token boundaries.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

try:
    import regex as _regex
    # llama.cpp's LLAMA3 pretokenizer pattern
    _LLAMA3_PRETOK = _regex.compile(
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
        r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
        r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
except ImportError:  # pragma: no cover — regex is in the base image
    _regex = None
    _LLAMA3_PRETOK = None

# llama.cpp token types
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

_SP_SPACE = "▁"  # ▁


@lru_cache(maxsize=1)
def gpt2_byte_to_unicode() -> dict[int, str]:
    """GPT-2 bytes→unicode table: printable ranges map to themselves, the
    rest to U+0100.. (tokenizer.cpp:14-50)."""
    identity = (list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256)))
    table = {}
    n = 0
    for b in range(256):
        if b in identity:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


@lru_cache(maxsize=1)
def gpt2_unicode_to_byte() -> dict[str, int]:
    return {v: k for k, v in gpt2_byte_to_unicode().items()}


class Tokenizer:
    """BPE tokenizer over a GGUF vocab."""

    def __init__(self, tokens: list[str], scores=None, token_types=None,
                 merges: list[str] | None = None, bos_id: int = 1, eos_id: int = 2):
        self.tokens = list(tokens)
        self.scores = (np.asarray(scores, dtype=np.float32)
                       if scores is not None and len(scores) else None)
        self.token_types = (np.asarray(token_types, dtype=np.int32)
                            if token_types is not None and len(token_types) else None)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.unk_id: int | None = None  # set from GGUF unknown_token_id
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        # Detect encoding: Llama 3 vocab contains 'Ġ' (GPT-2-encoded space)
        self.use_gpt2 = gpt2_byte_to_unicode()[0x20] in self.token_to_id
        # Rank-driven merges when available (lower rank = higher priority)
        self.merge_rank: dict[tuple[str, str], int] = {}
        if merges:
            for rank, m in enumerate(merges):
                left, _, right = m.partition(" ")
                self.merge_rank[(left, right)] = rank
        self.max_token_chars = max((len(t) for t in self.tokens), default=1)
        # Special tokens (CONTROL/USER_DEFINED) are matched literally BEFORE
        # pretokenization — the LLAMA3 regex would split '<|eot_id|>' into
        # punctuation pieces that can never BPE back to the control id (the
        # reference gets this right via longest-match seeding,
        # tokenizer.cpp:121-166; the exact-BPE path needs pre-segmentation)
        self.special_ids: dict[str, int] = {}
        if self.token_types is not None:
            for i, t in enumerate(self.tokens):
                if i < len(self.token_types) and self.token_types[i] in (
                        TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
                    self.special_ids[t] = i
        else:  # no type array: recognize the conventional special shapes
            for t, i in self.token_to_id.items():
                if (t.startswith("<|") and t.endswith("|>")) or t in (
                        "<s>", "</s>", "<unk>", "<pad>"):
                    self.special_ids[t] = i
        self._special_re = None
        if self.special_ids and _regex is not None:
            alts = sorted(self.special_ids, key=len, reverse=True)
            self._special_re = _regex.compile(
                "|".join(_regex.escape(t) for t in alts))
        # Generation stop set: eos plus end-of-turn style control tokens
        # (Llama-3 chat emits <|eot_id|>, never <|end_of_text|>)
        self.stop_ids: set[int] = {self.eos_id}
        for name in ("<|eot_id|>", "<|end_of_text|>", "<|eom_id|>",
                     "<|im_end|>", "<|endoftext|>", "</s>",
                     "<end_of_turn>"):  # gemma chat end-of-turn
            tid = self.token_to_id.get(name)
            if tid is not None:
                self.stop_ids.add(tid)

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "Tokenizer":
        tokens = md.get("tokenizer.ggml.tokens")
        if tokens is None:
            raise ValueError("GGUF has no tokenizer.ggml.tokens vocabulary")
        tok = cls(
            tokens=tokens,
            scores=md.get("tokenizer.ggml.scores"),
            token_types=md.get("tokenizer.ggml.token_type"),
            merges=md.get("tokenizer.ggml.merges"),
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
        )
        eot = md.get("tokenizer.ggml.eot_token_id")
        if eot is not None:
            tok.stop_ids.add(int(eot))
        unk = md.get("tokenizer.ggml.unknown_token_id")
        if unk is None:
            unk = tok.token_to_id.get("<unk>")
        if unk is not None:
            tok.unk_id = int(unk)
        return tok

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # --- encode ---------------------------------------------------------------
    def _to_internal(self, text: str) -> str:
        if self.use_gpt2:
            b2u = gpt2_byte_to_unicode()
            return "".join(b2u[b] for b in text.encode("utf-8"))
        return text.replace(" ", _SP_SPACE)

    def _byte_fallback_ids(self, piece: str) -> list[int]:
        """Byte-token ids for a piece with no whole-vocab match — ONE id
        PER BYTE (an earlier version returned only the first byte's token,
        silently dropping the rest of multi-byte characters)."""
        out: list[int] = []
        if self.use_gpt2:
            # chars are GPT-2 PROXIES — map each back to its original byte
            # before forming the <0xXX> lookup (advisor finding r1)
            u2b = gpt2_unicode_to_byte()
            for c in piece:
                tid = self.token_to_id.get(c)
                if tid is not None:
                    out.append(tid)
                    continue
                b = u2b.get(c)
                tid = (self.token_to_id.get(f"<0x{b:02X}>")
                       if b is not None else None)
                self._append_or_unk(out, tid)
            return out
        # SentencePiece byte tokens <0xXX>, one per UTF-8 byte
        for b in piece.encode("utf-8"):
            tid = self.token_to_id.get(f"<0x{b:02X}>")
            self._append_or_unk(out, tid)
        return out

    def _append_or_unk(self, out: list[int], tid: int | None) -> None:
        """Unmappable byte: emit the vocab's unk token, or drop it — never
        a hardcoded id 0 (a real text token in GPT-2-style vocabs:
        advisor finding r2)."""
        if tid is not None:
            out.append(tid)
        elif self.unk_id is not None:
            out.append(self.unk_id)

    def _bpe_piece(self, piece: str) -> list[str]:
        """Canonical BPE inside one pretoken: seed single (byte-mapped)
        characters, repeatedly apply the LOWEST-rank merge."""
        parts = list(piece)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.merge_rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def _encode_bpe_exact(self, text: str,
                          allow_special: bool = False) -> list[int]:
        """Upstream-exact GPT-2/Llama-3 byte-level BPE (merges path)."""
        b2u = gpt2_byte_to_unicode()
        out: list[int] = []
        for m in _LLAMA3_PRETOK.finditer(text):
            piece = "".join(b2u[b] for b in m.group().encode("utf-8"))
            for p in self._bpe_piece(piece):
                tid = self._lookup(p, allow_special)
                if tid is not None:
                    out.append(tid)
                else:
                    out.extend(self._byte_fallback_ids(p))
        return out

    def encode(self, text: str, add_bos: bool = True,
               parse_special: bool = True) -> list[int]:
        """parse_special: match CONTROL/USER_DEFINED vocab entries literally
        (chat templates need this; the reference always does, via its
        longest-match seeding). False treats them as plain text."""
        out = [self.bos_id] if add_bos else []
        if not text:
            return out
        if parse_special and self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    out.extend(self._encode_text(text[pos:m.start()]))
                out.append(self.special_ids[m.group()])
                pos = m.end()
            if pos < len(text):
                out.extend(self._encode_text(text[pos:]))
            return out
        # No pre-segmentation: allow direct vocab matches of special strings
        # only when the caller asked for specials (greedy longest-match can
        # otherwise smuggle control ids from untrusted text — advisor r2)
        out.extend(self._encode_text(text, allow_special=parse_special))
        return out

    def _lookup(self, s: str, allow_special: bool) -> int | None:
        tid = self.token_to_id.get(s)
        if tid is not None and not allow_special and s in self.special_ids:
            return None
        return tid

    def _encode_text(self, text: str, allow_special: bool = False) -> list[int]:
        """Encode one span. allow_special permits special-token strings to
        match as whole vocab entries (pre-segmentation-free path only)."""
        if not text:
            return []
        if self.use_gpt2 and self.merge_rank and _LLAMA3_PRETOK is not None:
            return self._encode_bpe_exact(text, allow_special)
        out: list[int] = []
        enc = self._to_internal(text)
        # Greedy longest-match seeding (tokenizer.cpp:121-166)
        parts: list[str] = []
        pos = 0
        n = len(enc)
        cap = min(self.max_token_chars, 64)
        while pos < n:
            for ln in range(min(cap, n - pos), 0, -1):
                if self._lookup(enc[pos:pos + ln], allow_special) is not None:
                    parts.append(enc[pos:pos + ln])
                    pos += ln
                    break
            else:
                parts.append(enc[pos])
                pos += 1

        # Merge loop: rank-driven if merges exist, else score-driven
        if self.merge_rank:
            def merge_key(a: str, b: str):
                r = self.merge_rank.get((a, b))
                return (-r) if r is not None else None
        else:
            def merge_key(a: str, b: str):
                tid = self._lookup(a + b, allow_special)
                if tid is None:
                    return None
                if self.scores is not None and tid < len(self.scores):
                    return float(self.scores[tid])
                return 0.0

        while len(parts) > 1:
            best, best_i = None, -1
            for i in range(len(parts) - 1):
                k = merge_key(parts[i], parts[i + 1])
                if k is not None and (best is None or k > best):
                    best, best_i = k, i
            if best_i < 0:
                break
            parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]

        for p in parts:
            tid = self._lookup(p, allow_special)
            if tid is not None:
                out.append(tid)
            else:
                out.extend(self._byte_fallback_ids(p))
        return out

    # --- decode ---------------------------------------------------------------
    def token_bytes(self, token_id: int) -> bytes:
        """Raw UTF-8 bytes one token contributes to the output stream
        (control/unused/out-of-range tokens contribute none)."""
        if token_id < 0 or token_id >= len(self.tokens):
            return b""
        if self.token_types is not None and token_id < len(self.token_types):
            if self.token_types[token_id] in (TOKEN_TYPE_CONTROL,
                                              TOKEN_TYPE_UNUSED):
                return b""
        tok = self.tokens[token_id]
        if self.use_gpt2:
            u2b = gpt2_unicode_to_byte()
            return bytes(u2b[c] if c in u2b else ord(c) & 0xFF for c in tok)
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                return bytes([int(tok[3:5], 16)])
            except ValueError:
                pass
        return tok.replace(_SP_SPACE, " ").encode("utf-8")

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder(self)

    def decode_token(self, token_id: int) -> str:
        """Decode one token; control/unused tokens decode to '' (tokenizer.cpp:240-246)."""
        if token_id < 0 or token_id >= len(self.tokens):
            return ""
        if self.token_types is not None and token_id < len(self.token_types):
            if self.token_types[token_id] in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNUSED):
                return ""
        tok = self.tokens[token_id]
        if self.use_gpt2:
            u2b = gpt2_unicode_to_byte()
            raw = bytes(u2b[c] if c in u2b else ord(c) & 0xFF for c in tok)
            return raw.decode("utf-8", errors="replace")
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                return chr(int(tok[3:5], 16))
            except ValueError:
                pass
        return tok.replace(_SP_SPACE, " ")

    def decode(self, token_ids) -> str:
        # Decode at the BYTE level so multi-byte UTF-8 split across tokens
        # (GPT-2 byte proxies or SP <0xXX> byte-fallback runs) reassembles
        # (the reference decodes per-token and can split code points).
        raw = bytearray()
        for tid in token_ids:
            raw.extend(self.token_bytes(tid))
        return raw.decode("utf-8", errors="replace")


class StreamDecoder:
    """Incremental detokenizer for STREAMING callbacks: buffers raw bytes
    across tokens and flushes only complete UTF-8 sequences, so a
    multi-byte character split over several tokens never streams as
    mojibake (advisor finding r2 — decode_token rendered SP <0xXX> bytes
    one chr() at a time). push() is called once per token and may return
    '' while a code point is still incomplete; the concatenation of all
    returned pieces equals Tokenizer.decode of the same ids."""

    def __init__(self, tok: Tokenizer):
        self.tok = tok
        self.buf = bytearray()

    @staticmethod
    def _complete_prefix_len(buf: bytearray) -> int:
        """Length of the longest prefix that doesn't end mid-code-point."""
        n = len(buf)
        for j in range(1, min(4, n) + 1):
            b = buf[n - j]
            if b & 0xC0 != 0x80:  # ASCII or a lead byte
                if b < 0x80:
                    need = 1
                elif b >> 5 == 0b110:
                    need = 2
                elif b >> 4 == 0b1110:
                    need = 3
                elif b >> 3 == 0b11110:
                    need = 4
                else:
                    need = 1  # invalid lead byte: flush (decodes to U+FFFD)
                return n if j >= need else n - j
        return n  # 4+ continuation bytes: invalid anyway, flush

    def push(self, token_id: int) -> str:
        self.buf.extend(self.tok.token_bytes(token_id))
        cut = self._complete_prefix_len(self.buf)
        if cut == 0:
            return ""
        piece = bytes(self.buf[:cut]).decode("utf-8", errors="replace")
        del self.buf[:cut]
        return piece

    def flush(self) -> str:
        """Drain any trailing incomplete bytes (end of generation)."""
        piece = bytes(self.buf).decode("utf-8", errors="replace")
        self.buf.clear()
        return piece

    def flush_to(self, callback) -> None:
        """End-of-stream: hand any trailing bytes to the callback."""
        tail = self.flush()
        if tail:
            callback(tail)
