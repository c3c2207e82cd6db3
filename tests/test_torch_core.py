"""vokselis_torch core against vokselis_tpu on the same inputs (CPU).

Inputs are made with numpy from fixed seeds and handed to both packages.
Float tolerances are 1e-6 absolute: a few float32 ulps at the magnitudes
involved (values in [0, 1], ray components in [-1, 1]), which is what two
correct float32 implementations differ by when an operation order, a
transcendental's last bit or an fma differs.

Tests that need JAX import it through ``pytest.importorskip`` inside the
test, so this file also collects where JAX is absent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vokselis_torch.core import colors, geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.volume.io import get_bonsai

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
RAY_ILL_COND = 5e-4

POSES = {
    "default": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.0, 0.0, 0.0)),
    "bonsai": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5)),
    "xor": dict(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
    "diagonal": dict(zoom=1.3, pitch=0.2, yaw=2.2, target=(0.5, 0.5, 0.5)),
}


def _cams(pose, aspect):
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera

    return Camera(aspect=aspect, **POSES[pose]), JaxCamera(aspect=aspect, **POSES[pose])


def _close(port, ref, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("n", [32, 256])
def test_get_bonsai_byte_identical(n):
    pytest.importorskip("jax")
    from vokselis_tpu.volume.io import get_bonsai as jax_get_bonsai

    port, ref = get_bonsai(n), jax_get_bonsai(n)
    assert port.dtype == ref.dtype == np.uint8
    assert port.shape == ref.shape == (n, n, n)
    assert port.tobytes() == ref.tobytes()


@pytest.mark.parametrize("pose", ["default", "bonsai", "xor"])
def test_camera_matches_jax(pose):
    cam, jcam = _cams(pose, 16 / 9)
    np.testing.assert_array_equal(cam.build_projection_view_matrix(),
                                  jcam.build_projection_view_matrix())
    u, ju = cam.uniform("cpu"), jcam.uniform()
    for name in ("view_position", "proj_view", "inv_proj"):
        t = getattr(u, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ju, name)))
    assert cam.eye == jcam.eye


@pytest.mark.parametrize("move", ["add_zoom(-100)", "add_pitch(100)",
                                  "add_pitch(-100)", "add_zoom(1000)"])
def test_camera_clamps_match_jax(move):
    cam, jcam = _cams("bonsai", 1.0)
    name, arg = move.rstrip(")").split("(")
    getattr(cam, name)(float(arg))
    getattr(jcam, name)(float(arg))
    assert (cam.zoom, cam.pitch, cam.yaw, cam.eye) == (
        jcam.zoom, jcam.pitch, jcam.yaw, jcam.eye)
    assert cam.updated and jcam.updated
    np.testing.assert_array_equal(cam.uniform("cpu").inv_proj.numpy(),
                                  np.asarray(jcam.uniform().inv_proj))
    if move == "add_zoom(-100)":
        assert cam.zoom == pytest.approx(0.3)


def test_camera_uniform_from_numpy_copies():
    vp = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    pv = np.arange(16, dtype=np.float64).reshape(4, 4)
    u = CameraUniform.from_numpy(vp, pv, np.eye(4), "cpu")
    assert u.proj_view.dtype == torch.float32
    vp[0] = 9.0
    assert float(u.view_position[0]) == pytest.approx(0.1)
    np.testing.assert_array_equal(u.proj_view.numpy(), pv.astype(np.float32))


@pytest.mark.parametrize("pose", ["default", "bonsai", "xor", "eye_inside", "diagonal"])
@pytest.mark.parametrize("size", [(64, 36), (32, 32)])
def test_rays_fragment_soa_matches_jax(pose, size):
    w, h = size
    cam, jcam = _cams(pose, w / h)
    from vokselis_tpu.core import geometry as jgeom

    # the JAX camera's state carried across: far-plane unprojection cancels
    # (w ~ 0.01 from terms ~10), so a 1-ulp difference in inv_proj would move
    # ray directions by ~3e-4 and hide what this test checks
    ju = jcam.uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position),
                                 np.asarray(ju.proj_view), np.asarray(ju.inv_proj),
                                 "cpu")
    np.testing.assert_array_equal(u.inv_proj.numpy(), cam.uniform("cpu").inv_proj.numpy())
    eye, (dx, dy, dz) = geometry.rays_fragment_soa(u, w, h)
    jeye, (jdx, jdy, jdz) = jgeom.rays_fragment_soa(ju, w, h)
    _close(eye, jeye)
    for a, b in ((dx, jdx), (dy, jdy), (dz, jdz)):
        assert a.shape == (h, w) and a.dtype == torch.float32
        _close_rays(a, b)
    # the AoS form the oracle marches agrees with the SoA form
    _, dirs = geometry.rays_fragment(u, w, h)
    _, jdirs = jgeom.rays_fragment(ju, w, h)
    _close_rays(dirs, jdirs)
    _close_rays(dirs, torch.stack([dx, dy, dz], dim=-1))


def _close_rays(port, ref):
    """Ray directions: within ATOL on at least 99% of components, and within
    RAY_ILL_COND everywhere. The far-plane point's w (~0.01) is the
    difference of terms ~10, so one ulp of 10 (9.5e-7) that one compiler
    rounds differently (an fma contraction, say) moves w by ~1e-4 relative
    and a direction by up to ~3e-4, on a few pixels."""
    err = np.abs(port.numpy() - np.asarray(ref))
    assert (err <= ATOL).mean() >= 0.99, (err <= ATOL).mean()
    assert err.max() <= RAY_ILL_COND, err.max()


def test_intersect_box_soa_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core import geometry as jgeom

    rng = np.random.default_rng(1)
    e = rng.uniform(-1.5, 2.5, (3, 40, 50)).astype(np.float32)
    d = rng.normal(size=(3, 40, 50)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t0, t1 = geometry.intersect_box_soa(*torch.from_numpy(e), *torch.from_numpy(d), 0.0, 1.0)
    j0, j1 = jgeom.intersect_box_soa(*jnp.asarray(e), *jnp.asarray(d), 0.0, 1.0)
    hit = (t0 <= t1).numpy()
    np.testing.assert_array_equal(hit, np.asarray(j0 <= j1))
    assert 0.1 < hit.mean() < 0.9  # the seed gives both hits and misses
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-6, atol=ATOL)
    # the AoS slab test the oracle uses agrees with the SoA one
    a0, a1 = geometry.intersect_box_unit(torch.from_numpy(np.moveaxis(e, 0, -1)),
                                         torch.from_numpy(np.moveaxis(d, 0, -1)))
    np.testing.assert_array_equal(a0.numpy(), t0.numpy())
    np.testing.assert_array_equal(a1.numpy(), t1.numpy())


def _color_inputs():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.2, 1.5, 4096).astype(np.float32)
    x[:8] = [0.0, 0.0031308, 0.1, 0.9, 1.2, 1e-13, 0.5, 1.0]
    return x


COLOR_FUNCS = {
    "smoothstep": lambda m, x: m.smoothstep(0.10, 1.2, x),
    "mix": lambda m, x: m.mix(x, 1.0 - x, 0.25 * x),
    # the sRGB encoders see values in [0, 1] (composited rgb; ACES output)
    "linear_to_srgb": lambda m, x: m.linear_to_srgb(abs(x) / 1.5),
    "linear_to_srgb_present": lambda m, x: m.linear_to_srgb_present(abs(x) / 1.5),
    "aces_film": lambda m, x: m.aces_film(4.0 * x),
    "palette": lambda m, x: m.palette(x, 0.5, 0.5, 1.7, 0.15),
    "vertigo": lambda m, x: m.vertigo(x),
    "vertigo_soa": lambda m, x: m.vertigo_soa(x),
    "bonsai_transfer_soa": lambda m, x: m.bonsai_transfer_soa(x),
}


@pytest.mark.parametrize("name", sorted(COLOR_FUNCS))
def test_colors_match_jax(name):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core import colors as jcolors

    assert colors.TAU == jcolors.TAU == 6.28318
    x = _color_inputs()
    port = COLOR_FUNCS[name](colors, torch.from_numpy(x))
    ref = COLOR_FUNCS[name](jcolors, jnp.asarray(x))
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r)
    else:
        assert port.shape == ref.shape
        _close(port, ref)


def test_transfer_keeps_min_quirk():
    # min(0.9, v): samples above 0.9 all map to smoothstep(0.10, 1.2, 0.9)
    tv, _, _, _ = colors.bonsai_transfer_soa(torch.tensor([0.9, 0.95, 1.0]))
    assert float(tv[0]) == float(tv[1]) == float(tv[2])
    assert float(tv[0]) == pytest.approx(0.8174305, abs=1e-6)
    tv0, _, _, _ = colors.bonsai_transfer_soa(torch.tensor([0.0, 0.1]))
    assert float(tv0.abs().max()) == 0.0


def test_import_without_jax():
    """The port imports with JAX made unimportable, and pulls in nothing of
    the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import vokselis_torch, vokselis_torch.models.bonsai, "
        "vokselis_torch.engine.loop, vokselis_torch.ops.cuda.march_bonsai, "
        "vokselis_torch.ops.shear_warp, vokselis_torch.ops.cuda.shear_resample, "
        "vokselis_torch.ops.cuda.warp2d, vokselis_torch.ops.hybrid, "
        "vokselis_torch.tools.hybrid_sweep, vokselis_torch.models, "
        "vokselis_torch.ops.cuda.march_field, vokselis_torch.ops.cuda.genvol, "
        "vokselis_torch.ops.raster, vokselis_torch.volume.fields, "
        "vokselis_torch.parallel, vokselis_torch.parallel.sharding, "
        "vokselis_torch.engine, vokselis_torch.engine.state, vokselis_torch.engine.reload, "
        "vokselis_torch.engine.compiler, vokselis_torch.engine.profiler, "
        "vokselis_torch.native, vokselis_torch.media.recorder, vokselis_torch.volume.io\n"
        "bad = [m for m in sys.modules if m.startswith(('vokselis_tpu', 'jax'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
