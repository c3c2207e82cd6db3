"""Utilities: grid math, small host helpers (SURVEY.md H15)."""

from vokselis_torch.utils.grid import cdiv, dispatch_optimal, round_up
from vokselis_torch.utils.misc import (
    ContinuousDict,
    ImageDimensions,
    create_folder,
    green_blink,
)

__all__ = [
    "dispatch_optimal",
    "cdiv",
    "round_up",
    "ContinuousDict",
    "ImageDimensions",
    "create_folder",
    "green_blink",
]
