"""Scene-state checkpoint/resume (absent in the reference — SURVEY.md §5
'Checkpoint / resume': scene + camera + time as a serializable state, for
exact-frame reproduction).

The state is everything that determines a frame: camera orbit parameters
(zoom/pitch/yaw/target/aspect — the eye is derived), the global uniform, and
the frame index. Volumes are identified by name/path, not serialized. The
JSON layout is the JAX package's (``vokselis_tpu/engine/state.py``) key for
key, so a file saved by either package loads in the other. Uniform tensors
are read back to host floats; restoring rebuilds the camera uniform on the
context's device.
"""

from __future__ import annotations

import json


def capture_state(ctx) -> dict:
    """Snapshot a Context's frame-determining state as a JSON-able dict."""
    cam = ctx.camera
    u = ctx.global_uniform
    return {
        "version": 1,
        "camera": {
            "zoom": cam.zoom,
            "pitch": cam.pitch,
            "yaw": cam.yaw,
            "target": list(cam.target),
            "aspect": cam.aspect,
        },
        "uniform": {
            "pos": [float(x) for x in u.pos.cpu()],
            "frame": int(u.frame),
            "resolution": [float(x) for x in u.resolution.cpu()],
            "mouse": [float(x) for x in u.mouse.cpu()],
            "mouse_pressed": int(u.mouse_pressed),
            "time": float(u.time),
            "time_delta": float(u.time_delta),
        },
        "window": [ctx.width, ctx.height],
        "frame": ctx.frame,
    }


def restore_state(ctx, state: dict) -> None:
    """Restore a snapshot into a Context (exact-frame reproduction)."""
    c = state["camera"]
    cam = ctx.camera
    cam.zoom = float(c["zoom"])
    cam.pitch = float(c["pitch"])
    cam.yaw = float(c["yaw"])
    cam.target = tuple(c["target"])
    cam.aspect = float(c["aspect"])
    cam._fix_eye()
    u = state["uniform"]
    ctx.global_uniform = ctx.global_uniform.with_(
        pos=u["pos"],
        frame=u["frame"],
        resolution=u["resolution"],
        mouse=u["mouse"],
        mouse_pressed=u["mouse_pressed"],
        time=u["time"],
        time_delta=u["time_delta"],
    )
    ctx.resize(*state["window"])
    ctx.camera.updated = False  # resize marks dirty; the uniform is rebuilt here
    ctx.camera_uniform = cam.uniform(ctx.device)
    ctx.frame = int(state["frame"])


def save_state(ctx, path: str) -> None:
    with open(path, "w") as f:
        json.dump(capture_state(ctx), f, indent=1)


def load_state(ctx, path: str) -> None:
    with open(path) as f:
        restore_state(ctx, json.load(f))
