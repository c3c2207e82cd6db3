"""Demo protocol (mirrors the Demo trait, src/lib.rs:37-43).

``init`` is required; the rest default to no-ops exactly like the trait's
default methods. Demos render into ``ctx.render_backbuffer`` and may use
``ctx.shader_compiler`` / ``ctx.watcher`` freely (SURVEY.md L6).
"""

from __future__ import annotations


class Demo:
    @classmethod
    def init(cls, ctx) -> "Demo":
        raise NotImplementedError

    def resize(self, ctx, width: int, height: int) -> None:
        pass

    def update(self, ctx) -> None:
        pass

    def update_input(self, event) -> None:
        """``event``: a dict like {'type': 'key', 'key': 'f1', 'pressed': True}."""

    def render(self, ctx) -> None:
        pass
