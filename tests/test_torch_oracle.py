"""The port's plain-torch oracle (K1's plain version), sampler and present
pass against the JAX package's jnp oracle, on the same inputs (CPU).

Frame tolerances are the exact kernel's parity contract
(tests/test_pallas.py:104-107): max < 1e-3, mean < 1e-5. Two float32
marches of the same ray can differ by one step where a ceil- or
compare-derived step count or an ulp-level cos difference moves the
alpha >= 0.95 exit or the box exit by one sample, on rare pixels; everywhere
else they agree to ~1e-6. Camera state is carried across with
``CameraUniform.from_numpy`` so both packages march the same uniform.
"""

import os

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.media.png import read_png
from vokselis_torch.ops.present import present, to_uint8
from vokselis_torch.ops.reference import render_bonsai
from vokselis_torch.volume.io import get_bonsai
from vokselis_torch.volume.sample import sample_nearest, sample_trilinear_r8

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5)),
    "eye_inside": dict(zoom=0.3, pitch=0.1, yaw=0.7, target=(0.5, 0.5, 0.5)),
    "diagonal": dict(zoom=1.3, pitch=0.2, yaw=2.2, target=(0.5, 0.5, 0.5)),
}


def border_volume(n):
    """test_pallas.py:285-286: random values everywhere, borders included."""
    return np.random.default_rng(5).integers(30, 220, (n, n, n), dtype=np.uint8)


def carried_uniform(jax_uniform):
    """The JAX camera's uniform as the port's (the state carried across)."""
    return CameraUniform.from_numpy(
        np.asarray(jax_uniform.view_position), np.asarray(jax_uniform.proj_view),
        np.asarray(jax_uniform.inv_proj), "cpu")


def assert_frame_parity(port, ref):
    err = np.abs(port.numpy() - np.asarray(ref))
    assert np.isfinite(port.numpy()).all()
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-5, err.mean()


def test_sample_trilinear_r8_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.volume import sample as jsample

    rng = np.random.default_rng(3)
    vol = rng.integers(0, 256, (24, 20, 16), dtype=np.uint8)
    # beyond [0, 1] on purpose: the ClampToEdge taps, low and high edges
    p = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    port = sample_trilinear_r8(torch.from_numpy(vol), torch.from_numpy(p))
    ref = jsample.sample_trilinear_r8(jnp.asarray(vol), jnp.asarray(p))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    volf = vol.astype(np.float32) / 255.0
    portf = sample_trilinear_r8(torch.from_numpy(volf), torch.from_numpy(p))
    np.testing.assert_allclose(portf.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_sample_nearest_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.volume import sample as jsample

    rng = np.random.default_rng(4)
    vol = rng.normal(size=(8, 9, 10, 4)).astype(np.float32)
    idx = rng.integers(-3, 13, (200, 3)).astype(np.int32)
    port = sample_nearest(torch.from_numpy(vol), torch.from_numpy(idx))
    ref = jsample.sample_nearest(jnp.asarray(vol), jnp.asarray(idx))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("volume,pose,size", [
    ("bonsai256", "bench", (64, 36)),
    ("bonsai256", "eye_inside", (64, 36)),
    ("bonsai256", "diagonal", (64, 36)),
    ("border32", "bench", (32, 32)),
    ("border32", "diagonal", (32, 32)),
])
def test_render_bonsai_matches_jax_oracle(volume, pose, size):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai

    vol = get_bonsai() if volume == "bonsai256" else border_volume(32)
    w, h = size
    ju = JaxCamera(aspect=w / h, **POSES[pose]).uniform()
    port = render_bonsai(torch.from_numpy(vol), carried_uniform(ju), width=w, height=h)
    ref = jax_render_bonsai(jnp.asarray(vol), ju, width=w, height=h)
    assert port.shape == (h, w, 4) and port.dtype == torch.float32
    assert_frame_parity(port, ref)
    assert port[..., :3].max() > 0.1  # the pose sees the volume


@pytest.mark.parametrize("out_size", [None, (72, 128), (20, 30)])
def test_present_and_to_uint8_match_jax(out_size):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.present import present as jax_present
    from vokselis_tpu.ops.present import to_uint8 as jax_to_uint8

    rng = np.random.default_rng(6)
    hdr = rng.uniform(0.0, 3.0, (36, 64, 4)).astype(np.float32)
    hdr[:4, :4] = 0.0
    oh, ow = out_size or (None, None)
    # a resize samples at texel coordinates (i + 0.5) / out * size - 0.5 of
    # magnitude <= 64, where one float32 ulp is 7.6e-6 texel; across this
    # random image's texel-to-texel jumps of up to 3.0 that is <= 2.3e-5
    atol = 1e-6 if out_size is None else 3e-5
    port = present(torch.from_numpy(hdr), out_height=oh, out_width=ow)
    ref = np.array(jax_present(jnp.asarray(hdr), out_height=oh, out_width=ow))
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=atol)
    raw = present(torch.from_numpy(hdr), out_height=oh, out_width=ow, tonemap=False)
    raw_ref = jax_present(jnp.asarray(hdr), out_height=oh, out_width=ow,
                          tonemap=False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_ref), rtol=0, atol=atol)
    # quantization of the same floats is exact
    np.testing.assert_array_equal(to_uint8(torch.from_numpy(ref)).numpy(),
                                  np.asarray(jax_to_uint8(jnp.asarray(ref))))


def test_bonsai_golden():
    """The port's oracle reproduces tests/goldens/bonsai.png (made from the
    JAX oracle) within tests/test_golden.py's tolerances."""
    w, h = 160, 90
    cam = Camera(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5), aspect=w / h)
    hdr = render_bonsai(torch.from_numpy(get_bonsai()), cam.uniform("cpu"),
                        width=w, height=h)
    cur = to_uint8(present(hdr)).numpy().astype(np.int32)
    gold = read_png(os.path.join(GOLDENS, "bonsai.png")).astype(np.int32)
    err = np.abs(cur - gold)
    assert err.mean() < 1.0, err.mean()
    assert (err > 8).mean() < 0.01, (err > 8).mean()
