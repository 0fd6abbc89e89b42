"""Chat templating: GGUF-driven message formatting for the chat surfaces.

The port's own copy of ntransformer_tpu/inference/chat.py (that module
imports no JAX; the port keeps its own copy of what it needs). The GGUF's
`tokenizer.chat_template` (Jinja source) is FINGERPRINTED to one of the
known families and rendered natively, falling back to vocab inspection
when the key is absent.

Security model: rendering returns SEGMENTS, not one string. Scaffold
segments (role headers, turn terminators) encode with parse_special=True;
message CONTENT always encodes with parse_special=False, so a user typing
'<|eot_id|>' in a chat message cannot smuggle the control id, the same
boundary the serve path enforces for raw prompts.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Segment:
    text: str
    special: bool  # encode with parse_special=True (trusted scaffold)


# roles the templates accept — the role string is FORMATTED INTO a
# special-parsing scaffold segment, so free-form roles would be a
# control-id smuggling channel (a role of 'user<|eot_id|>...' would
# forge turn boundaries); everything else is rejected at encode time
ALLOWED_ROLES = frozenset({"system", "user", "assistant", "tool"})


@dataclass(frozen=True)
class ChatFormat:
    """One template family. Scaffold strings may reference tokens the
    vocab lacks (e.g. [INST] in plain-text llama-2 vocabs) — encode()
    then falls back to ordinary text, which is exactly those templates'
    semantics."""
    name: str
    # (prefix, suffix) around each message's content, both .format(role=)
    msg_prefix: str
    msg_suffix: str
    # trailing scaffold that cues the assistant's reply
    generation_prompt: str

    def render(self, messages: list[dict],
               add_generation_prompt: bool = True) -> list[Segment]:
        segs: list[Segment] = []
        for m in messages:
            role, content = m["role"], m["content"]
            segs.append(Segment(self.msg_prefix.format(role=role), True))
            segs.append(Segment(content, False))
            segs.append(Segment(self.msg_suffix.format(role=role), True))
        if add_generation_prompt:
            segs.append(Segment(self.generation_prompt, True))
        return segs


@dataclass(frozen=True)
class _Llama2Format(ChatFormat):
    """llama-2/mistral instruct: '<s>[INST] user [/INST] reply</s>' per
    exchange; a system message folds into the following user turn inside
    <<SYS>> markers. The simple prefix/suffix shape can't express the
    role asymmetry, so render() is specialized."""

    def render(self, messages: list[dict],
               add_generation_prompt: bool = True) -> list[Segment]:
        segs: list[Segment] = []
        pending_sys: str | None = None
        for m in messages:
            role, content = m["role"], m["content"]
            if role == "system":
                pending_sys = content
            elif role == "assistant":
                segs.append(Segment(" ", True))
                segs.append(Segment(content, False))
                segs.append(Segment("</s><s>", True))
            else:  # user / tool
                segs.append(Segment("[INST] ", True))
                if pending_sys is not None:
                    segs.append(Segment("<<SYS>>\n", True))
                    segs.append(Segment(pending_sys, False))
                    segs.append(Segment("\n<</SYS>>\n\n", True))
                    pending_sys = None
                segs.append(Segment(content, False))
                segs.append(Segment(" [/INST]", True))
        return segs


LLAMA3 = ChatFormat(
    name="llama3",
    msg_prefix="<|start_header_id|>{role}<|end_header_id|>\n\n",
    msg_suffix="<|eot_id|>",
    generation_prompt="<|start_header_id|>assistant<|end_header_id|>\n\n",
)

CHATML = ChatFormat(  # qwen2 family
    name="chatml",
    msg_prefix="<|im_start|>{role}\n",
    msg_suffix="<|im_end|>\n",
    generation_prompt="<|im_start|>assistant\n",
)

LLAMA2 = _Llama2Format(
    name="llama2",
    msg_prefix="", msg_suffix="", generation_prompt="",  # unused: render()
)


@dataclass(frozen=True)
class _GemmaFormat(ChatFormat):
    """gemma family: '<start_of_turn>user\\n...<end_of_turn>\\n' per turn
    with the assistant role spelled 'model'. Gemma has NO system role —
    a system message folds into the next user turn (llama.cpp's handling;
    the upstream Jinja template rejects system outright). Stop token is
    <end_of_turn> (tokenizer stop set)."""

    def render(self, messages: list[dict],
               add_generation_prompt: bool = True) -> list[Segment]:
        segs: list[Segment] = []
        pending_sys: str | None = None
        for m in messages:
            role, content = m["role"], m["content"]
            if role == "system":
                pending_sys = content
                continue
            grole = "model" if role == "assistant" else "user"
            segs.append(Segment(f"<start_of_turn>{grole}\n", True))
            if pending_sys is not None and grole == "user":
                segs.append(Segment(pending_sys, False))
                segs.append(Segment("\n\n", True))
                pending_sys = None
            segs.append(Segment(content, False))
            segs.append(Segment("<end_of_turn>\n", True))
        if add_generation_prompt:
            segs.append(Segment("<start_of_turn>model\n", True))
        return segs


GEMMA = _GemmaFormat(
    name="gemma",
    msg_prefix="", msg_suffix="", generation_prompt="",  # unused: render()
)

_FORMATS = {f.name: f for f in (LLAMA3, CHATML, LLAMA2, GEMMA)}


def detect_format(metadata: dict, tokenizer=None) -> ChatFormat | None:
    """Fingerprint `tokenizer.chat_template` (Jinja source), falling back
    to vocab inspection. None = no known chat format (raw prompts only)."""
    tpl = metadata.get("tokenizer.chat_template")
    if tpl:
        tpl = str(tpl)
        if "start_header_id" in tpl:
            return LLAMA3
        if "im_start" in tpl:
            return CHATML
        if "start_of_turn" in tpl:
            return GEMMA
        if "[INST]" in tpl:
            return LLAMA2
    if tokenizer is not None:
        vocab = tokenizer.token_to_id
        if "<|start_header_id|>" in vocab:
            return LLAMA3
        if "<|im_start|>" in vocab:
            return CHATML
        if "<start_of_turn>" in vocab:
            return GEMMA
    return None


def get_format(name: str) -> ChatFormat:
    return _FORMATS[name]


def encode_chat(tokenizer, fmt: ChatFormat, messages: list[dict],
                add_generation_prompt: bool = True) -> list[int]:
    """Messages → token ids. Scaffold segments parse specials; content
    segments never do (no control-id smuggling through chat content)."""
    for m in messages:
        if not isinstance(m.get("role"), str) \
                or not isinstance(m.get("content"), str):
            raise ValueError("each message needs string 'role' and "
                             "'content'")
        if m["role"] not in ALLOWED_ROLES:
            # the role is formatted into a SPECIAL-parsing scaffold
            # segment: a free-form role would smuggle control ids
            raise ValueError(f"role must be one of "
                             f"{sorted(ALLOWED_ROLES)}, got {m['role']!r}")
    ids: list[int] = [tokenizer.bos_id]
    for seg in fmt.render(messages, add_generation_prompt):
        if not seg.text:
            continue
        ids.extend(tokenizer.encode(seg.text, add_bos=False,
                                    parse_special=seg.special))
    return ids
