"""Tool-call extraction from generated text.

Parity: reference ``lib/llm/src/preprocessor/tools.rs`` —
``ToolCallingMatcher`` accepts a completed assistant message that IS a
JSON tool invocation and converts it to OpenAI ``tool_calls`` entries.
Accepted shapes (same as the reference's serde attempts, in order):

- ``{"name": ..., "parameters": {...}}``
- ``[{"name": ..., "parameters": {...}}, ...]``
- ``{"name": ..., "arguments": {...}}``
- ``[{"name": ..., "arguments": {...}}, ...]``

Extension beyond the reference (the models this framework serves
natively emit it): the qwen/hermes ``<tool_call> {...} </tool_call>``
wrapper — each wrapped block parses with the same shapes. A message that
parses as tool calls returns them and the HTTP layer reports
``finish_reason: "tool_calls"`` with ``content: null``; anything else
returns ``[]`` and the text passes through untouched.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional

_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>",
                           re.DOTALL)


def _one_call(obj: Any) -> Optional[Dict[str, Any]]:
    """A dict of {name, parameters|arguments} -> OpenAI tool_call entry."""
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("parameters", obj.get("arguments"))
    if not isinstance(args, dict):
        return None
    return {
        "id": f"call-{uuid.uuid4()}",
        "type": "function",
        "function": {"name": obj["name"],
                     "arguments": json.dumps(args)},
    }


def _from_json_text(text: str) -> List[Dict[str, Any]]:
    try:
        obj = json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return []
    if isinstance(obj, dict):
        call = _one_call(obj)
        return [call] if call else []
    if isinstance(obj, list):
        calls = [_one_call(o) for o in obj]
        if calls and all(c is not None for c in calls):
            return calls  # type: ignore[return-value]
    return []


def parse_tool_calls(message: str,
                     tool_choice: Any = "auto") -> List[Dict[str, Any]]:
    """Extract OpenAI ``tool_calls`` from a completed message, or ``[]``.

    ``tool_choice="none"`` disables parsing (reference:
    ``ToolCallingMatcher::get_call``)."""
    if tool_choice == "none":
        return []
    text = message.strip()
    if not text:
        return []
    wrapped = _TOOL_CALL_RE.findall(text)
    if wrapped:
        # the whole message must be tool calls (modulo whitespace) — a
        # prose answer that merely MENTIONS the tag stays text
        remainder = _TOOL_CALL_RE.sub("", text).strip()
        if remainder:
            return []
        calls: List[Dict[str, Any]] = []
        for block in wrapped:
            got = _from_json_text(block)
            if not got:
                return []
            calls.extend(got)
        return calls
    return _from_json_text(text)


def forced_tool_guided_spec(tools: Optional[List[Dict[str, Any]]],
                            tool_choice: Any) -> Optional[Dict[str, Any]]:
    """Guided-decoding spec that GUARANTEES a parseable tool call when
    ``tool_choice`` demands one — the engine-side realization of OpenAI's
    forced function calling (the reference forwards it to engines whose
    guided backends do the same).

    Returns None when nothing is forced (auto/none/absent). The forced
    output shape is exactly what :func:`parse_tool_calls` accepts:
    ``{"name": <tool>, "arguments": {...}}`` — ``name`` constrained to
    the allowed tool(s), ``arguments`` to the tool's declared parameter
    schema when this grammar can express it, else any JSON object (the
    caller downgrades on GuidedUnsupported).

    Raises ValueError on a tool_choice naming an undeclared function or
    demanding a call with no tools — a 400, matching OpenAI.
    """
    if tool_choice in (None, "auto", "none"):
        return None
    by_name: Dict[str, Dict[str, Any]] = {}
    for t in tools or ():
        fn = t.get("function") if isinstance(t, dict) else None
        if isinstance(fn, dict) and isinstance(fn.get("name"), str):
            by_name[fn["name"]] = fn
    if tool_choice == "required":
        names = list(by_name)
        if not names:
            raise ValueError("tool_choice='required' needs tools")
    elif (isinstance(tool_choice, dict)
          and isinstance(tool_choice.get("function"), dict)):
        name = tool_choice["function"].get("name")
        if name not in by_name:
            raise ValueError(
                f"tool_choice names unknown function {name!r}")
        names = [name]
    else:
        raise ValueError(f"unsupported tool_choice {tool_choice!r}")

    if len(names) == 1:
        params = by_name[names[0]].get("parameters")
        # only embed a schema that yields an OBJECT: parse_tool_calls
        # requires dict arguments, so a non-object parameters schema
        # (valid JSON Schema, but not a function signature) falls back to
        # any-object rather than forcing unparseable output
        is_obj = (isinstance(params, dict) and params
                  and (params.get("type") == "object"
                       or "properties" in params))
        args_schema = params if is_obj else {"type": "object"}
        name_schema: Dict[str, Any] = {"const": names[0]}
    else:
        # several candidates: our unions dispatch on the FIRST byte, and
        # every per-tool object starts with '{' — so constrain the name
        # to the declared set and leave arguments an open object
        args_schema = {"type": "object"}
        name_schema = {"enum": sorted(names)}
    return {"mode": "json_schema", "schema": {
        "type": "object",
        "properties": {"name": name_schema, "arguments": args_schema},
        "required": ["name", "arguments"],
    }}


def degrade_tool_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The fallback when a tool's own parameter schema uses keywords the
    grammar cannot enforce: same envelope, arguments open."""
    out = json.loads(json.dumps(spec))
    out["schema"]["properties"]["arguments"] = {"type": "object"}
    return out


__all__ = ["parse_tool_calls", "forced_tool_guided_spec",
           "degrade_tool_spec"]
