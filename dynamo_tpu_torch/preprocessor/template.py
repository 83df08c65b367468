"""Chat prompt templating via the model's HF-style jinja2 ``chat_template``.

Parity: reference ``lib/llm/src/preprocessor/prompt/template/`` (~570 LoC,
minijinja).  HF chat templates rely on a few non-standard jinja behaviors
(``raise_exception``, ``tojson`` filter, loop variables); we provide those on
a sandboxed jinja2 environment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jinja2
from jinja2.sandbox import ImmutableSandboxedEnvironment

DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ message.role }}: {{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}assistant:{% endif %}"
)


def _raise_exception(message: str) -> None:
    raise jinja2.exceptions.TemplateError(message)


class PromptFormatter:
    """Renders OpenAI `messages` into the model's prompt string."""

    def __init__(self, chat_template: Optional[str] = None,
                 bos_token: str = "", eos_token: str = ""):
        self._env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True, keep_trailing_newline=True)
        self._env.globals["raise_exception"] = _raise_exception
        self._template_src = chat_template or DEFAULT_CHAT_TEMPLATE
        self._template = self._env.from_string(self._template_src)
        self.bos_token = bos_token
        self.eos_token = eos_token

    def render(self, messages: List[Dict[str, Any]],
               add_generation_prompt: bool = True,
               tools: Optional[List[Dict[str, Any]]] = None,
               **extra: Any) -> str:
        ctx: Dict[str, Any] = {
            "messages": messages,
            "add_generation_prompt": add_generation_prompt,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
        }
        if tools is not None:
            ctx["tools"] = tools
        ctx.update(extra)
        return self._template.render(**ctx)


__all__ = ["PromptFormatter", "DEFAULT_CHAT_TEMPLATE"]
