"""Input state (mirrors Input, src/utils/input.rs:9-111).

Tracks held keys (arrows, slash, right-shift, enter, space), left mouse
button, and NDC mouse position with flipped y; ``process_position`` nudges
the global uniform's ``pos`` by +-0.01 per held key per frame and copies
mouse state into the uniform (input.rs:88-110).
"""

from __future__ import annotations

from dataclasses import dataclass

from vokselis_torch.core.uniforms import upload

MOVE_STEP = 0.01  # input.rs:92-107


@dataclass
class Input:
    up_pressed: bool = False
    down_pressed: bool = False
    left_pressed: bool = False
    right_pressed: bool = False
    slash_pressed: bool = False
    right_shift_pressed: bool = False
    enter_pressed: bool = False
    space_pressed: bool = False
    left_mouse_pressed: bool = False
    mouse: tuple = (0.0, 0.0)

    _KEYMAP = {
        "up": "up_pressed",
        "down": "down_pressed",
        "left": "left_pressed",
        "right": "right_pressed",
        "/": "slash_pressed",
        "rshift": "right_shift_pressed",
        "enter": "enter_pressed",
        "space": "space_pressed",
    }

    def update_key(self, key: str, pressed: bool) -> bool:
        """Returns True if the key is handled (input.rs:28-62)."""
        attr = self._KEYMAP.get(key.lower())
        if attr is None:
            return False
        setattr(self, attr, pressed)
        return True

    def update_mouse_pos(self, x: float, y: float, width: int, height: int):
        """Window coords -> NDC with flipped y (input.rs:64-75)."""
        self.mouse = (
            2.0 * x / width - 1.0,
            -(2.0 * y / height - 1.0),
        )

    def update_mouse_button(self, pressed: bool):
        self.left_mouse_pressed = pressed

    def process_position(self, uniform):
        """Nudge uniform.pos by held keys, copy mouse state
        (input.rs:88-110). Returns the updated GlobalUniform."""
        dx = (MOVE_STEP if self.right_pressed else 0.0) - (
            MOVE_STEP if self.left_pressed else 0.0
        )
        dy = (MOVE_STEP if self.up_pressed else 0.0) - (
            MOVE_STEP if self.down_pressed else 0.0
        )
        dz = (MOVE_STEP if self.slash_pressed else 0.0) - (
            MOVE_STEP if self.right_shift_pressed else 0.0
        )
        step = upload([dx, dy, dz], uniform.device)
        return uniform.with_(
            pos=uniform.pos + step,
            mouse=self.mouse,
            mouse_pressed=1 if self.left_mouse_pressed else 0,
        )
