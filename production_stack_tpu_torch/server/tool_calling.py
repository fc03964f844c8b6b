"""OpenAI tool calling (``tools`` / ``tool_choice``) for the chat endpoint.

Counterpart of ``production_stack_tpu/server/tool_calling.py``, the same
prompts, parser and stream buffering, so a port engine and a JAX engine
answer the same request with the same body:

  * Schema injection is prompt-side and template-agnostic: the functions'
    JSON schemas and the llama3.1-JSON calling convention ("respond with
    {\"name\": ..., \"parameters\": ...}") are merged into the system
    message before the chat template is applied, so any template, the
    byte tokenizer's included, serves tools.
  * A forced ``tool_choice`` ({"type": "function", "function": {"name":
    X}}) also seeds the assistant turn with the JSON prefix
    '{"name": "X", "parameters": '; the parser prepends the prefix before
    parsing.
  * The parser takes one JSON object or a JSON array of them, with
    ``parameters`` or ``arguments`` keys, anywhere in the output text.

Streaming: output is not known to be a tool call until it parses, so with
tools active a choice's text is buffered and delivered either as one
``tool_calls`` delta with finish_reason "tool_calls", or, once the text
cannot be a call any more, as content deltas passed through as generated.
"""

import json
from dataclasses import dataclass, field
from typing import List, Optional

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.utils import random_uuid

CALL_INSTRUCTION = (
    "You have access to the following functions. To call a function, "
    "respond ONLY with a JSON object of the form "
    '{"name": "<function-name>", "parameters": {...}} '
    "(use a JSON array of such objects for multiple calls). "
    "Do not add any other text when calling a function.\n\n"
)


def validate_tools(body: dict) -> Optional[str]:
    """Returns an error message for malformed tools/tool_choice, else None."""
    tools = body.get("tools")
    if tools is not None:
        if not isinstance(tools, list) or not tools:
            return "'tools' must be a non-empty list"
        for t in tools:
            if not isinstance(t, dict) or t.get("type") != "function" \
                    or not isinstance(t.get("function"), dict) \
                    or not t["function"].get("name"):
                return ("each tool must be {'type': 'function', "
                        "'function': {'name': ..., ...}}")
    tc = body.get("tool_choice")
    if tc is None:
        return None
    if tools is None and tc != "none":
        return "'tool_choice' requires 'tools'"
    if isinstance(tc, str):
        if tc not in ("none", "auto", "required"):
            return ("'tool_choice' must be 'none', 'auto', 'required' or "
                    "a {'type': 'function'} object")
        return None
    if isinstance(tc, dict):
        name = (tc.get("function") or {}).get("name")
        if tc.get("type") != "function" or not name:
            return ("forced 'tool_choice' must be {'type': 'function', "
                    "'function': {'name': ...}}")
        if tools is not None and name not in {
            t["function"]["name"] for t in tools
        }:
            return f"tool_choice function '{name}' is not in 'tools'"
        return None
    return "'tool_choice' must be a string or object"


@dataclass
class ToolContext:
    """Per-request tool state threaded through response generation."""
    tools: List[dict]
    tool_choice: object = "auto"
    forced_prefix: str = ""      # assistant seed text for a forced choice

    @property
    def forced_name(self) -> Optional[str]:
        if isinstance(self.tool_choice, dict):
            return self.tool_choice["function"]["name"]
        return None

    def full_text(self, generated: str) -> str:
        return self.forced_prefix + generated


def build_tool_context(body: dict) -> Optional[ToolContext]:
    """None when the request has no active tools (absent or choice 'none')."""
    tools = body.get("tools")
    tc = body.get("tool_choice")
    if not tools or tc == "none":
        return None
    ctx = ToolContext(tools=tools, tool_choice=tc if tc is not None else "auto")
    if ctx.forced_name:
        ctx.forced_prefix = f'{{"name": "{ctx.forced_name}", "parameters": '
    return ctx


def inject_tool_messages(messages: List[dict], ctx: ToolContext) -> List[dict]:
    """Return messages with the tool schemas merged into the system message
    and tool-history messages normalized into template-renderable content."""
    schemas = "\n".join(
        json.dumps(t["function"], sort_keys=True) for t in ctx.tools
    )
    section = CALL_INSTRUCTION + "Functions:\n" + schemas
    if ctx.forced_name:
        section += (
            f"\n\nYou MUST call the function \"{ctx.forced_name}\" now."
        )
    elif ctx.tool_choice == "required":
        section += "\n\nYou MUST call one of the functions now."
    out = []
    injected = False
    for m in messages:
        m = dict(m)
        if m.get("role") == "system" and not injected:
            m["content"] = f"{m.get('content') or ''}\n\n{section}".strip()
            injected = True
        elif m.get("role") == "assistant" and m.get("tool_calls"):
            # Past tool calls re-render as the JSON the model emitted, so
            # multi-turn tool conversations stay in-distribution. Client
            # history is untrusted: missing keys / non-JSON / already-dict
            # arguments must surface as a 400 upstream (the caller wraps
            # this in its malformed-messages handler), never a 500.
            calls = []
            for c in m["tool_calls"]:
                if not isinstance(c, dict) or not isinstance(
                    c.get("function"), dict
                ) or not c["function"].get("name"):
                    raise ValueError(
                        "assistant tool_calls history entries must be "
                        "{'function': {'name': ..., 'arguments': ...}}"
                    )
                args = c["function"].get("arguments") or {}
                if isinstance(args, str):
                    try:
                        args = json.loads(args)
                    except json.JSONDecodeError as e:
                        raise ValueError(
                            "tool_calls history 'arguments' is not valid "
                            f"JSON: {e}"
                        ) from e
                calls.append({
                    "name": c["function"]["name"], "parameters": args,
                })
            m["content"] = json.dumps(calls[0] if len(calls) == 1 else calls)
            m.pop("tool_calls", None)
        elif m.get("role") == "tool":
            # Render tool results with their call linkage inline; templates
            # without a native tool role still produce sensible text.
            name = m.get("name") or m.get("tool_call_id") or "tool"
            m["content"] = f"[{name} returned]: {m.get('content')}"
        out.append(m)
    if not injected:
        out.insert(0, {"role": "system", "content": section})
    return out


def _candidate_json(text: str) -> Optional[str]:
    """The first balanced {...} or [...] span in ``text``, or None."""
    start = None
    for i, ch in enumerate(text):
        if ch in "{[":
            start = i
            break
    if start is None:
        return None
    opener, closer = text[start], {"{": "}", "[": "]"}[text[start]]
    depth = 0
    in_str = False
    esc = False
    for i in range(start, len(text)):
        ch = text[i]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == opener:
            depth += 1
        elif ch == closer:
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
    return None


def parse_tool_calls(text: str, valid_names=None) -> Optional[List[dict]]:
    """Parse llama3_json-style tool calls out of generated text.

    Returns OpenAI `tool_calls` entries, or None when the text is not a
    tool call. Accepts one object or an array; `parameters` or
    `arguments`; names restricted to ``valid_names`` when given."""
    span = _candidate_json(text)
    if span is None:
        return None
    try:
        obj = json.loads(span)
    except json.JSONDecodeError:
        return None
    items = obj if isinstance(obj, list) else [obj]
    calls = []
    for item in items:
        if not isinstance(item, dict) or not isinstance(
            item.get("name"), str
        ):
            return None
        args = item.get("parameters", item.get("arguments", {}))
        if not isinstance(args, dict):
            return None
        if valid_names is not None and item["name"] not in valid_names:
            return None
        calls.append({
            "id": random_uuid("call-"),
            "type": "function",
            "function": {
                "name": item["name"],
                "arguments": json.dumps(args),
            },
        })
    return calls or None


def looks_like_tool_call_prefix(text: str) -> bool:
    """True while ``text`` could still grow into a parseable tool call —
    used by streaming to decide whether to keep buffering or flush as
    plain content."""
    stripped = text.lstrip()
    if not stripped:
        return True
    return stripped[0] in "{["


@dataclass
class StreamingToolBuffer:
    """Per-choice streaming state when tools are active: buffers text while
    it could be a tool call; once it provably isn't, flushes and passes
    content deltas through."""
    ctx: ToolContext
    buffered: str = ""
    passthrough: bool = False

    def feed(self, delta: str) -> str:
        """Returns the content to emit NOW ('' while buffering)."""
        if self.passthrough:
            return delta
        self.buffered += delta
        if not self.ctx.forced_prefix and not looks_like_tool_call_prefix(
            self.buffered
        ):
            self.passthrough = True
            out, self.buffered = self.buffered, ""
            return out
        return ""

    def finish(self):
        """(tool_calls | None, residual_content) at stream end."""
        if self.passthrough:
            return None, ""
        calls = parse_tool_calls(
            self.ctx.full_text(self.buffered),
            valid_names={t["function"]["name"] for t in self.ctx.tools},
        )
        if calls is not None:
            return calls, ""
        return None, self.buffered
