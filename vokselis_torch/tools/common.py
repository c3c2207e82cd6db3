"""What the port's measuring tools share: the device they run on (the card
unless the caller asks for the CPU, never a fallback), the card's
``nvidia-smi`` line, the frame error they report and the slope-timed frame
(:func:`vokselis_torch.bench.slope_time` over replays of a compiled entry).
"""

from __future__ import annotations

import os
import tempfile

import torch

from vokselis_torch import bench
from vokselis_torch.tools.parity_report import smi_line

# where the tools' scratch files (checkpoints, dumps, JSON) go by default
DEFAULT_OUT_DIR = os.path.join(tempfile.gettempdir(), "vokselis_torch")


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels, the default) or cpu (their plain versions)")


def device_of(parser, args) -> torch.device:
    """The device ``args.device`` names; a CUDA device without a card ends the
    program through ``parser.error`` (exit 2): the tools measure the card and
    run on the CPU only when asked."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda needs a CUDA card (torch.cuda.is_available() is False); "
                     "--device cpu runs the plain versions")
    return device


def card_of(device) -> str:
    """The card's ``nvidia-smi`` line on a CUDA ``device``, else the device's
    name and "(no card)"."""
    device = torch.device(device)
    return smi_line() if device.type == "cuda" else f"{device} (no card)"


def mean_rgb_err(a, b) -> float:
    """Mean |a - b| over the first three channels of two (H, W, C) frames,
    reduced on their device."""
    return float((a[..., :3] - b[..., :3]).abs().mean())


def frame_ms(frame, device) -> float:
    """Milliseconds per call of ``frame()`` (no arguments; on a card a graph
    replay): :func:`vokselis_torch.bench.slope_time` of that many calls,
    each run ending with the card's synchronize."""
    return bench.slope_time(lambda n: bench._frames(lambda i: frame(), n, device)) * 1e3
