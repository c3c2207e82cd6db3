"""The slice as a whole: the port's frame loop against the JAX package's, on
the same scripted events (CPU).

On the CPU both packages render the bonsai with their oracles, so the
display images are held to the exact kernel's contract (max < 1e-3, mean
< 1e-5; tests/test_pallas.py:104-107) and the camera state must be
identical: both run the same host-side camera code on the same events.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vokselis_torch.engine.context import Context, HdrBackBuffer, renderer_info
from vokselis_torch.engine.loop import run
from vokselis_torch.media.png import read_png
from vokselis_torch.models.bonsai import BonsaiDemo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from common import orbit_events  # noqa: E402


def test_run_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from vokselis_tpu.engine.context import Context as JaxContext
    from vokselis_tpu.engine.loop import run as jax_run
    from vokselis_tpu.models.bonsai import BonsaiDemo as JaxBonsaiDemo

    monkeypatch.chdir(tmp_path)
    ctx = run(BonsaiDemo, frames=2, events=orbit_events(2, 64, 36),
              context=Context(64, 36, backbuffer_resolution=(64, 36), device="cpu"),
              quiet=True)
    jctx = jax_run(JaxBonsaiDemo, frames=2, events=orbit_events(2, 64, 36),
                   context=JaxContext(64, 36, backbuffer_resolution=(64, 36)),
                   quiet=True)
    cam, jcam = ctx.camera, jctx.camera
    assert (cam.zoom, cam.pitch, cam.yaw, cam.eye, cam.aspect) == (
        jcam.zoom, jcam.pitch, jcam.yaw, jcam.eye, jcam.aspect)
    assert ctx.frame == jctx.frame == 2
    np.testing.assert_array_equal(ctx.camera_uniform.inv_proj.numpy(),
                                  np.asarray(jctx.camera_uniform.inv_proj))
    gu, jgu = ctx.global_uniform, jctx.global_uniform
    assert int(gu.frame) == int(jgu.frame) == 1
    assert int(gu.mouse_pressed) == int(jgu.mouse_pressed) == 1
    np.testing.assert_allclose(gu.mouse.numpy(), np.asarray(jgu.mouse), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gu.resolution.numpy(), np.asarray(jgu.resolution))

    img = ctx.display_image
    ref = np.asarray(jctx.display_image)
    assert img.shape == ref.shape == (36, 64, 4) and img.device.type == "cpu"
    img = img.numpy()
    assert np.isfinite(img).all()
    assert (img[..., :3].max(axis=-1) > 0.05).mean() > 0.01  # the volume is in view
    err = np.abs(img - ref)
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-5, err.mean()
    np.testing.assert_array_equal(ctx.capture_frame().shape, jctx.capture_frame().shape)


def test_context_update_matches_jax():
    pytest.importorskip("jax")
    from vokselis_tpu.engine.context import Context as JaxContext

    ctx = Context(width=64, height=64, device="cpu")
    jctx = JaxContext(width=64, height=64)
    for c in (ctx, jctx):
        c.input.update_key("up", True)
        c.input.update_mouse_pos(10, 20, 64, 64)
        c.camera.add_yaw(0.5)
        c.update(time=1.5, time_delta=1 / 30)
        c.update(time=2.0)
    gu, jgu = ctx.global_uniform, jctx.global_uniform
    for name in ("pos", "resolution", "mouse", "time", "time_delta"):
        t = getattr(gu, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jgu, name)))
    assert gu.frame.dtype == torch.uint32
    assert int(gu.frame) == int(jgu.frame) == 1
    assert not ctx.camera.updated and not jctx.camera.updated
    np.testing.assert_array_equal(ctx.camera_uniform.proj_view.numpy(),
                                  np.asarray(jctx.camera_uniform.proj_view))
    assert "Global Uniforms" in str(gu)


def test_context_backbuffer_and_capture():
    ctx = Context(width=32, height=32, backbuffer_resolution=(16, 16), device="cpu")
    assert ctx.render_backbuffer.resolution == (16, 16)
    with pytest.raises(ValueError):
        ctx.render_backbuffer.store(torch.zeros(8, 8, 4))
    ctx.render_backbuffer.store(torch.full((16, 16, 4), 0.5))
    img = ctx.render()
    assert img.shape == (32, 32, 4)
    frame = ctx.capture_frame()
    assert frame.dtype == np.uint8 and frame.shape == (32, 32, 4)
    ctx.resize(320, 180)
    assert ctx.render_backbuffer.resolution == (16, 16)
    assert ctx.camera.aspect == 320 / 180
    assert HdrBackBuffer("cpu").resolution == (1280, 720)
    assert "Vendor name: cpu" in renderer_info("cpu")


def test_context_needs_a_device():
    with pytest.raises(TypeError):
        Context(width=8, height=8)  # noqa: the device is a required keyword
    with pytest.raises(ValueError):
        run(BonsaiDemo, frames=1)


@pytest.mark.parametrize("renderer,item", [("hybrid", "item 6")])
def test_other_renderers_not_ported(renderer, item, monkeypatch):
    """The last of the JAX package's bonsai renderers, ported by ROADMAP
    queue 1 ``item``, builds; a renderer neither package has raises."""
    from vokselis_torch.models import bonsai as bonsai_model
    from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
    from vokselis_torch.volume.io import get_bonsai

    monkeypatch.setattr(bonsai_model, "get_bonsai", lambda: get_bonsai(32))
    ctx = Context(width=8, height=8, device="cpu")
    demo = BonsaiDemo.init(ctx, renderer=renderer)
    assert isinstance(demo.renderer, HybridBonsaiRenderer)
    assert demo.renderer.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown renderer"):
        BonsaiDemo.init(ctx, renderer="slow")


def test_screenshot_event(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    events = [{"type": "mouse_button", "pressed": True}, None,
              {"type": "key", "key": "f11", "pressed": True}, None,
              {"type": "key", "key": "esc", "pressed": True}, None]
    ctx = run(BonsaiDemo, frames=5, events=iter(events), quiet=True,
              context=Context(32, 18, backbuffer_resolution=(32, 18), device="cpu"))
    assert ctx.frame == 3  # esc ends the run after the frame it arrives in
    # the recorder's worker writes the screenshot before run() returns
    shots = os.listdir("screenshots")
    assert len(shots) == 1
    assert read_png(os.path.join("screenshots", shots[0])).shape == (18, 32, 4)


def test_entry_point_cpu(tmp_path):
    """examples/bonsai_torch.py --cpu runs the slice end to end, with JAX
    made unimportable, and writes the final frame as a PNG. (The demo
    renders the fixed 1280x720 backbuffer whatever the window size, as the
    reference does, so one frame is the cost here.)"""
    out = tmp_path / "frame.png"
    code = (
        "import runpy, sys; sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
        f"sys.argv = ['bonsai_torch.py', '--cpu', '--width', '48', '--height', '32',"
        f" '--frames', '1', '--orbit', '--out', {str(out)!r}]\n"
        f"runpy.run_path({os.path.join(ROOT, 'examples', 'bonsai_torch.py')!r},"
        " run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = read_png(str(out))
    assert img.shape == (32, 48, 4)
    assert img[..., :3].max() > 100


def test_profiler_trace_writes_a_chrome_trace(tmp_path, capsys):
    """profiler.trace (the JAX package's device trace) around a frame: a
    Chrome trace in ``logdir`` that names the frame's operations."""
    import json

    from vokselis_torch.engine.profiler import trace

    ctx = Context(16, 16, backbuffer_resolution=(16, 16), device="cpu")
    with trace(str(tmp_path / "tr")) as prof:
        ctx.render()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert f"profiler trace written to {prof.trace_path}" in capsys.readouterr().out


@pytest.mark.parametrize("name, kernel, want", [
    ("_ZN12_GLOBAL__N_118march_field_kernelEPKfS1_", "march_field_kernel", True),
    ("_ZN12_GLOBAL__N_116composite_kernelEPKf", "composite_kernel", True),
    ("_ZN12_GLOBAL__N_125resample_composite_kernelEPKf", "composite_kernel", False),
    ("_ZN12_GLOBAL__N_125resample_composite_kernelEPKf", "resample_composite_kernel", True),
    ("_ZN12_GLOBAL__N_117warp_stats_kernelILb1EEvPKf", "warp_stats_kernel", True),
    ("_ZN12_GLOBAL__N_117warp_stats_kernelILb1EEvPKf", "warp_kernel", False),
    ("march_bonsai_kernel", "march_bonsai_kernel", True),
    ("march_bonsai_kernel_v2", "march_bonsai_kernel", False),
])
def test_kernel_name_matches(name, kernel, want):
    """A graph node's function name, as the driver gives it (mangled), is
    matched to a kernel by its Itanium source name, never by a substring
    (composite_kernel is inside resample_composite_kernel)."""
    from vokselis_torch.engine.profiler import kernel_name_matches

    assert kernel_name_matches(name, kernel) is want


def test_count_kernels_from_trace_names():
    """count_kernels reads demangled trace names with word boundaries; the
    CPU's trace has no device event, so kernel_launches counts 0."""
    from vokselis_torch.engine.profiler import count_kernels, kernel_launches

    names = ["void (anonymous namespace)::resample_composite_kernel(float const*)",
             "void (anonymous namespace)::composite_kernel(float const*)",
             "void (anonymous namespace)::warp_stats_kernel<true>(float const*)",
             "Memcpy DtoD (Device -> Device)"]
    assert count_kernels(names, ["composite_kernel", "resample_composite_kernel",
                                 "warp_stats_kernel", "warp_kernel"]) == {
        "composite_kernel": 1, "resample_composite_kernel": 1, "warp_stats_kernel": 1,
        "warp_kernel": 0}
    out, counts = kernel_launches(lambda: torch.ones(4).sum(), ["march_bonsai_kernel"])
    assert float(out) == 4.0 and counts == {"march_bonsai_kernel": 0}


@pytest.mark.gpu
def test_graph_kernels_count_a_replay_on_gpu():
    """The kernel nodes of a compiled field frame's graph, read through the
    CUDA driver: K7 once and no other port kernel, the count a replay's
    trace gives when it holds records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vokselis_torch.core.camera import Camera
    from vokselis_torch.engine.profiler import graph_kernels, kernel_launches
    from vokselis_torch.ops.cuda.march_field import FieldRenderer

    names = ["march_field_kernel", "march_bonsai_kernel", "warp_kernel"]
    r = FieldRenderer("cuda")
    u = Camera.xor(1.0).uniform("cuda")
    first = r(u, 0.0, 128, 128)
    graph = r.compiled.graph(r.compiled.keys()[-1])
    assert graph_kernels(graph, names) == {"march_field_kernel": 1, "march_bonsai_kernel": 0,
                                           "warp_kernel": 0}
    replay, counts = kernel_launches(lambda: r(u, 0.0, 128, 128), names)
    assert torch.equal(replay, first) and r.compiled.captures == 1
    assert counts in ({"march_field_kernel": 1, "march_bonsai_kernel": 0, "warp_kernel": 0},
                      dict.fromkeys(names, 0))
