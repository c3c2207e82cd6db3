"""The xor and trig demos of the port (vokselis_torch.models.xor / trig), the
rasterizer (vokselis_torch.ops.raster), PassTimer, orbit_camera_batch and the
field slice's goldens, on the CPU.

The goldens (tests/goldens/xor.png, trig_field.png, trig.png) were made by
tools/make_goldens.py from the JAX oracles; the port's oracles and
rasterizer reproduce them within tests/test_golden.py:30-31's tolerances
(mean < 1 level, < 1 % of components off by more than 8). The demos run
through engine.loop.run on a CPU context, where the xor demo takes K7's
plain version.

Tests marked ``gpu`` need a CUDA card and skip without one.
"""

import os

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.engine.profiler import PassTimer, kernel_launches
from vokselis_torch.media.png import read_png
from vokselis_torch.models import TrigDemo, XorDemo
from vokselis_torch.models import xor as xor_model
from vokselis_torch.ops import raster, reference
from vokselis_torch.ops.cuda import march_field as mf
from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.parallel import orbit_camera_batch

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
W, H = 160, 90
TRI = ((-0.5, -0.5, 0.0), (0.5, -0.5, 0.0), (0.0, 0.5, 0.0))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _check_golden(name, hdr):
    cur = to_uint8(present(hdr)).numpy().astype(np.int32)
    gold = read_png(os.path.join(GOLDENS, name)).astype(np.int32)
    err = np.abs(cur - gold)
    assert err.mean() < 1.0, f"{name}: mean err {err.mean()}"
    assert (err > 8).mean() < 0.01, f"{name}: {(err > 8).mean():.3%} px off by >8"


def _xor_cam(aspect):
    return Camera(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0), aspect=aspect)


# -- goldens -----------------------------------------------------------------------------

def test_xor_golden():
    hdr = reference.render_compute_inline(_xor_cam(W / H).uniform("cpu"), time=0.0,
                                          width=W, height=H)
    _check_golden("xor.png", hdr)


def test_xor_golden_through_k7_plain():
    """K7's plain version with the oracle's normals (grad="fd") renders the
    same golden; the sphere clip changes nothing visible."""
    hdr = mf.render_field(_xor_cam(W / H).uniform("cpu"), 0.0, W, H, grad="fd")
    _check_golden("xor.png", hdr)


def test_trig_field_golden():
    hdr = reference.render_field(_xor_cam(W / H).uniform("cpu"), time=0.0, width=W, height=H)
    _check_golden("trig_field.png", hdr)


def test_trig_triangle_golden():
    cam = Camera.default(aspect=W / H)
    img = raster.rasterize_triangle(cam.uniform("cpu").proj_view, *TRI,
                                    (0.25, 0.0, 1.0, 1.0), W, H)
    _check_golden("trig.png", img)


# -- the rasterizer ---------------------------------------------------------------------------

def _carried(ju):
    return CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                    np.asarray(ju.inv_proj), "cpu")


@pytest.mark.parametrize("yaw", [1.0, 2.5, 4.0])
def test_rasterize_triangle_matches_jax(yaw):
    """Coverage and colour against the JAX rasterizer on the same
    proj_view: equal at >= 99.9 % of pixels (an edge function that lands
    within an ulp of 0 may flip)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.raster import rasterize_triangle as jax_raster

    ju = JaxCamera(zoom=1.2, pitch=0.3, yaw=yaw, aspect=4 / 3).uniform()
    u = _carried(ju)
    color = (0.7, 0.2, 1.0, 1.0)
    port = raster.rasterize_triangle(u.proj_view, *TRI, color, 64, 48)
    ref = np.asarray(jax_raster(ju.proj_view, *(jnp.asarray(v) for v in TRI),
                                jnp.asarray(color), 64, 48))
    assert port.shape == (48, 64, 4)
    same = (port.numpy() == ref).all(axis=-1)
    assert same.mean() >= 0.999
    assert (port.numpy()[..., 0] == 0.7).any()  # the triangle is in view
    # a tensor vertex and colour give the same frame as Python floats
    tv = [torch.tensor(v, dtype=torch.float32) for v in TRI]
    assert torch.equal(port, raster.rasterize_triangle(
        u.proj_view, *tv, torch.tensor(color), 64, 48))


def test_raster_leftovers_match_jax():
    """The unreferenced reference leftovers (shader.wgsl, shader_sec.wgsl,
    quad.wgsl) against the JAX package's."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops import raster as jraster

    np.testing.assert_array_equal(raster.cameraless_triangle(2.75, 32, 24).numpy(),
                                  np.asarray(jraster.cameraless_triangle(2.75, 32, 24)))
    np.testing.assert_array_equal(raster.magenta_mini_triangle(32, 24).numpy(),
                                  np.asarray(jraster.magenta_mini_triangle(32, 24)))
    np.testing.assert_array_equal(raster.fullscreen_quad(8, 4).numpy(),
                                  np.asarray(jraster.fullscreen_quad(8, 4)))


# -- the demos --------------------------------------------------------------------------------

def _ctx(demo_cls, w, h, device="cpu"):
    return Context(w, h, camera=demo_cls.default_camera(w / h), backbuffer_resolution=(w, h),
                   device=device)


def test_run_xor_demo_cpu():
    """run(XorDemo) on a CPU context: finite frames, the frame K7's plain
    version renders at the frozen generation time, and the orbit moves the
    camera."""
    ctx = run(XorDemo, frames=2, context=_ctx(XorDemo, 48, 27), quiet=True,
              events=[{"type": "mouse_button", "pressed": True},
                      {"type": "mouse_move", "x": 10, "y": 10, "dragging": True}, None,
                      {"type": "mouse_move", "x": 30, "y": 12, "dragging": True}, None])
    img = ctx.display_image
    assert img.shape == (27, 48, 4) and bool(torch.isfinite(img).all())
    hdr = ctx.render_backbuffer.texture
    assert torch.equal(hdr, mf.render_field(ctx.camera_uniform, 0.0, 48, 27))
    assert float(hdr[..., :3].max()) > 0.05  # the cloud is in view


def test_xor_demo_f1_toggle_keeps_the_frame():
    """F1 switches SinglePass <-> Tile (the kernel's block rows 8 <-> 16);
    the frame stays bitwise the same (main.rs:189-208)."""
    ctx = _ctx(XorDemo, 40, 24)
    demo = XorDemo.init(ctx, grad="fd")
    ctx.update(time=1.5)
    demo.render(ctx)
    single = ctx.render_backbuffer.texture
    demo.update_input({"type": "key", "key": "F1", "pressed": True})
    assert demo.mode == "Tile" and xor_model.MODE_TILE_H["Tile"] == 16
    demo.render(ctx)
    assert torch.equal(ctx.render_backbuffer.texture, single)
    # the field stays frozen at init (time 0) until regenerate()
    assert torch.equal(single, mf.render_field(ctx.camera_uniform, 0.0, 40, 24, grad="fd"))
    demo.regenerate(ctx)
    demo.render(ctx)
    assert torch.equal(ctx.render_backbuffer.texture,
                       mf.render_field(ctx.camera_uniform, 1.5, 40, 24, grad="fd"))


def test_run_trig_demo_cpu():
    """run(TrigDemo): the triangle in (fract(time), mouse_pressed, 1, 1)
    over black, launching no kernel."""
    before = mf.LAUNCHES_FIELD
    ctx = run(TrigDemo, frames=2, context=_ctx(TrigDemo, 64, 36), quiet=True,
              events=[{"type": "mouse_button", "pressed": True}, None, None])
    img = ctx.render_backbuffer.texture
    assert bool(torch.isfinite(ctx.display_image).all())
    t = float(ctx.global_uniform.time)
    inside = img[..., 2] == 1.0
    assert inside.any() and not inside.all()
    np.testing.assert_allclose(img[inside][:, :2].numpy(),
                               np.broadcast_to([t - np.floor(t), 1.0], (int(inside.sum()), 2)),
                               rtol=0, atol=1e-6)
    assert (img[~inside] == torch.tensor([0.0, 0.0, 0.0, 1.0])).all()
    assert mf.LAUNCHES_FIELD == before


def test_pass_timer_reports_on_cpu(capsys):
    timer = PassTimer("raycast shader", report_every=3, device="cpu")
    for _ in range(3):
        with timer.measure(n_rays=1000):
            sum(range(1000))
    out = capsys.readouterr().out
    assert "Time on raycast shader" in out and "Mrays/s" in out
    assert timer.last_ms > 0.0 and timer.count == 3


def test_orbit_camera_batch_matches_jax():
    """One batched uniform, as the JAX package's stacked batch; each view
    equal to that batch's."""
    pytest.importorskip("jax")
    from vokselis_tpu.parallel.sharding import orbit_camera_batch as jax_batch

    views = orbit_camera_batch(6, device="cpu")
    ref = jax_batch(6)
    assert views.batched and len(views) == 6
    for i, u in enumerate(views):
        for name in ("view_position", "proj_view", "inv_proj"):
            np.testing.assert_allclose(getattr(u, name).numpy(),
                                       np.asarray(getattr(ref, name))[i], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_xor_demo_launches_k7_once_per_frame_on_gpu(cuda_device):
    """On a CUDA context each xor frame launches K7 once (counted on the
    device: replayed frames call no wrapper), both modes give the same
    frame, and it equals the plain version."""
    ctx = _ctx(XorDemo, 128, 72, "cuda")
    ctx, counts = kernel_launches(lambda: run(
        XorDemo, frames=3, context=ctx, quiet=True,
        events=[None, {"type": "key", "key": "f1", "pressed": True}, None, None]),
        ["march_field_kernel"])
    assert counts == {"march_field_kernel": 3}
    hdr = ctx.render_backbuffer.texture
    assert torch.equal(hdr, mf.render_field_plain(ctx.camera_uniform, 0.0, 128, 72))
