"""The procedural fields and volume generation of the port
(vokselis_torch.volume.fields / fields_soa, and K9 / K8 in
vokselis_torch.ops.cuda.genvol) against the JAX package, on the CPU.

Tolerances. The fbm hash fract(sin(n) * 43758.5453123) cannot be bitwise
equal between PyTorch and XLA on the CPU: their float32 sines differ by one
ulp on ~2 % of the lattice arguments the field produces (|n| up to 3.5e5),
and the x43758 amplification turns that into hash differences above 1e-3 on
~1 % of arguments and up to ~1 where fract wraps. So port-vs-JAX tests hold
means and high quantiles, never the max. Inside the port, the fused and
separate evaluations are held bitwise, and the analytic gradient to the
angle bounds of tests/test_fields.py:25-51. Every input is made from a numpy
seed.

Tests marked ``gpu`` need a CUDA card and skip without one: they launch K9
and K8 and hold them bitwise against their plain versions
(tests/test_torch_genvol_table.py holds the kernels' table and brick
windows on the CPU).
"""

import importlib
import math

import numpy as np
import pytest
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import CameraUniform
from vokselis_torch.core.colors import fract
from vokselis_torch.ops.cuda import genvol
from vokselis_torch.volume import fields, fields_soa

SIN_TS = (0.0, 0.71)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50): the plain versions
    run many small torch ops, and an OpenMP team per op oversubscribes the
    CPU under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_genvol():
    """The JAX package's genvol module with every pallas_call in interpret
    mode (test_pallas.py:16-38), reloaded back afterwards."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    name = "vokselis_tpu.ops.pallas.genvol"
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        yield importlib.reload(importlib.import_module(name))
    finally:
        pl.pallas_call = orig
        importlib.reload(importlib.import_module(name))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _coords(seed, n=4096, lattice=False):
    """(cx, cy, cz) as numpy float32: uniform in [-1, 1], or voxel centres
    of a 256^3 grid (test_fields.py:37-38)."""
    rng = np.random.default_rng(seed)
    if lattice:
        g = rng.integers(0, 256, size=(3, n))
        return [((v - 128.0) / 256.0).astype(np.float32) for v in g]
    return [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]


def _close(port, ref, mean, q99, q=0.99):
    d = np.abs(np.asarray(port, np.float64) - np.asarray(ref, np.float64))
    assert np.isfinite(np.asarray(port)).all()
    assert d.mean() <= mean, f"mean {d.mean():.3e} > {mean:g}"
    assert np.quantile(d, q) <= q99, f"q{q} {np.quantile(d, q):.3e} > {q99:g}"


# -- core additions -------------------------------------------------------------

def test_fract_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core.colors import fract as jfract

    x = np.random.default_rng(1).uniform(-1e3, 1e3, 1000).astype(np.float32)
    np.testing.assert_array_equal(fract(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfract(jnp.asarray(x))))


@pytest.mark.parametrize("size", [(48, 27), (32, 32)])
def test_rays_compute_match_jax(size):
    """rays_compute / rays_compute_soa (the y *= -aspect quirk and the
    per-pixel eye) on the JAX camera's uniform carried across; the slab test
    against [-1, 1]^3. Directions unproject the far plane, so a one-ulp
    difference of two float32 programs moves them by ~1e-4 (the
    test_rays_fragment_soa_matches_jax bound)."""
    pytest.importorskip("jax")
    from vokselis_tpu.core import geometry as jgeo
    from vokselis_tpu.core.camera import Camera as JaxCamera

    w, h = size
    ju = JaxCamera.xor(w / h).uniform()
    u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                 np.asarray(ju.inv_proj), "cpu")
    eye, d = geometry.rays_compute(u, w, h)
    jeye, jd = jgeo.rays_compute(ju, w, h)
    np.testing.assert_allclose(eye.numpy(), np.asarray(jeye), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=5e-4)
    (ex, ey, ez), (dx, dy, dz) = geometry.rays_compute_soa(u, w, h)
    (jex, jey, jez), jdd = jgeo.rays_compute_soa(ju, w, h)
    np.testing.assert_allclose(torch.stack([ex, ey, ez], -1).numpy(),
                               np.stack([np.asarray(v) for v in (jex, jey, jez)], -1),
                               rtol=0, atol=1e-5)
    # the SoA and AoS forms of the port agree with each other
    np.testing.assert_allclose(torch.stack([dx, dy, dz], -1).numpy(), d.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack([np.asarray(v) for v in jdd], -1), d.numpy(), rtol=0,
                               atol=5e-4)
    t0, t1 = geometry.intersect_box_sym(eye.reshape(-1, 3), d.reshape(-1, 3))
    jt0, jt1 = jgeo.intersect_box_sym(jeye.reshape(-1, 3), jd.reshape(-1, 3))
    assert ((t0 < t1).numpy() == np.asarray(jt0 < jt1)).mean() > 0.99
    assert (t0 < t1).any() and not (t0 < t1).all()


# -- structure-of-arrays fields ----------------------------------------------------

@pytest.mark.parametrize("sin_t", SIN_TS)
@pytest.mark.parametrize("name", ["noise_volume", "noise_volume_grad",
                                  "noise_volume_grad_analytic", "xor_field", "trig_field"])
def test_fields_soa_match_jax(name, sin_t):
    """Each SoA field against the JAX package's at 4096 random coordinates.
    Bounds (measured port-vs-XLA: alpha mean ~6e-7, normal means ~1e-5 to
    5e-5): alpha and normals mean <= 1e-4 and 99th percentile <= 5e-3,
    the unwindowed value mean <= 1e-3 (its hash differences are not damped
    by the radial window)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.volume import fields_soa as jfs

    c = _coords(11)
    port = getattr(fields_soa, name)(*(torch.from_numpy(x) for x in c), sin_t)
    ref = getattr(jfs, name)(*(jnp.asarray(x) for x in c), sin_t)
    assert len(port) == len(ref)
    for k, (p, r) in enumerate(zip(port, ref)):
        assert p.dtype == torch.float32 and p.shape == (4096,)
        if k == 0:
            _close(p.numpy(), r, mean=1e-3, q99=5e-3)
        else:
            _close(p.numpy(), r, mean=1e-4, q99=5e-3)


@pytest.mark.parametrize("sin_t", SIN_TS)
def test_noise_volume_grad_bitwise_matches_separate_evals(sin_t):
    """test_fields.py:3 in the port: the hash-shared fused evaluation is
    BITWISE noise_volume + gradient (exact lattice arithmetic); K9 relies on
    it to compute 60 hash sines a voxel where its plain version computes
    120."""
    cx, cy, cz = (torch.from_numpy(x) for x in _coords(11))
    v0, a0 = fields_soa.noise_volume(cx, cy, cz, sin_t)
    g = fields_soa.gradient(cx, cy, cz, sin_t)
    fused = fields_soa.noise_volume_grad(cx, cy, cz, sin_t)
    for got, want in zip(fused, (v0, a0) + g):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sin_t", SIN_TS)
def test_noise_volume_grad_analytic_value_bitwise_normal_close(sin_t):
    """test_fields.py:25 in the port: the analytic variant keeps val and
    alpha bitwise, and its normal stays within the one-sided difference's
    angle bounds (mean < 1.5 deg, 99th percentile < 10 deg) at voxel
    centres inside the window."""
    cx, cy, cz = (torch.from_numpy(x) for x in _coords(7, 8192, lattice=True))
    fv, fa, gx, gy, gz = fields_soa.noise_volume_grad(cx, cy, cz, sin_t)
    av, aa, ax, ay, az = fields_soa.noise_volume_grad_analytic(cx, cy, cz, sin_t)
    assert torch.equal(av, fv) and torch.equal(aa, fa)
    dot = (gx * ax + gy * ay + gz * az).numpy()
    r = torch.sqrt(cx * cx + cy * cy + cz * cz).numpy()
    m = (r < 0.5) & (fa.numpy() > 1e-3)
    ang = np.degrees(np.arccos(np.clip(dot[m], -1.0, 1.0)))
    assert m.sum() > 100
    assert ang.mean() < 1.5, ang.mean()
    assert np.percentile(ang, 99) < 10.0


# -- array-of-structures fields (the oracles') ------------------------------------

@pytest.mark.parametrize("time", [0.0, 1.7])
def test_fields_aos_match_soa(time):
    """Inside the port the AoS fields (the oracles') and the SoA fields (the
    kernels') are one field: noise and xor bitwise; the AoS gradient and the
    trig field within 1e-6 (the AoS norm sums through torch.sum, the SoA
    forms add left to right)."""
    c = [torch.from_numpy(x) for x in _coords(5)]
    coord = torch.stack(c, dim=-1)
    t = torch.tensor(time, dtype=torch.float32)
    sin_t = torch.sin(t * 1.0)
    for aos, soa, arg in ((fields.noise_volume, fields_soa.noise_volume, sin_t),
                          (fields.xor_field, fields_soa.xor_field, sin_t),
                          (fields.trig_field, fields_soa.trig_field, t)):
        got = aos(coord, t)
        val, alpha = soa(*c, arg)
        for k in range(3):
            np.testing.assert_allclose(got[..., k].numpy(), val.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[..., 3].numpy(), alpha.numpy(), rtol=0, atol=1e-6)
    n_aos = fields.gradient(coord, t)
    n_soa = torch.stack(fields_soa.gradient(*c, sin_t), dim=-1)
    d = (n_aos - n_soa).abs().numpy()
    assert d.mean() < 1e-6 and np.quantile(d, 0.99) < 1e-5


@pytest.mark.parametrize("name", ["noise_volume", "xor_field", "trig_field", "gradient"])
def test_fields_aos_match_jax(name):
    """The AoS fields against the JAX package's at time 0.7, with
    test_fields_soa_match_jax's bounds: alpha and normals mean <= 1e-4, the
    unwindowed value channels mean <= 1e-3, 99th percentiles <= 5e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.volume import fields as jfields

    coord = np.stack(_coords(5), axis=-1)
    port = getattr(fields, name)(torch.from_numpy(coord), 0.7).numpy()
    ref = np.asarray(getattr(jfields, name)(jnp.asarray(coord), 0.7))
    assert port.shape == ref.shape
    if name == "gradient":
        _close(port, ref, mean=1e-4, q99=5e-3)
    else:
        _close(port[..., :3], ref[..., :3], mean=1e-3, q99=5e-3)
        _close(port[..., 3], ref[..., 3], mean=1e-4, q99=5e-3)


# -- K9 and K8: volume generation -----------------------------------------------------

@pytest.mark.parametrize("time", [0.0, 1.25])
def test_generate_xor_volumes_plain_matches_jax_kernel(jax_genvol, time):
    """K9's plain version against generate_xor_volumes_pallas in interpret
    mode at D = 16, with test_pallas.py:80-90's bounds read as quantiles:
    density 99.9th percentile < 2e-3, normals 99th percentile < 1e-2
    (normals flip where a hash differs). The density's mean is held at
    1e-4, not 1e-5: its value channels are unwindowed, so the one-ulp sine
    differences show (measured 1.3e-5 to 4.3e-5)."""
    d_p, n_p = genvol.generate_xor_volumes(time, 16, "cpu")
    d_j, n_j = jax_genvol.generate_xor_volumes_pallas(time, dims=16, tile_z=8, tile_y=8)
    assert tuple(d_p.shape) == tuple(n_p.shape) == (16, 16, 16, 4)
    assert d_p.dtype == n_p.dtype == torch.float32
    _close(d_p.numpy(), d_j, mean=1e-4, q99=2e-3, q=0.999)
    dn = np.abs(n_p.numpy() - np.asarray(n_j))
    assert np.quantile(dn, 0.99) < 1e-2, np.quantile(dn, 0.99)


def test_generate_xor_volumes_plain_matches_fields():
    """K9's plain version (the SoA fields) against the port's AoS
    fields.generate_xor_volumes: density bitwise, normals within 1e-6."""
    d_p, n_p = genvol.generate_xor_volumes_plain(0.4, 16, "cpu")
    d_a, n_a = fields.generate_xor_volumes(16, 0.4)
    np.testing.assert_array_equal(d_p.numpy(), d_a.numpy())
    np.testing.assert_allclose(n_p.numpy(), n_a.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("time", [0.0, 1.25])
def test_generate_density_u8_matches_jax_kernel(jax_genvol, time):
    """K8's plain version against generate_density_u8_pallas in interpret
    mode at D = 16: at most one level apart (test_pallas.py:583-603)."""
    got = genvol.generate_density_u8(time, 16, "cpu")
    want = np.asarray(jax_genvol.generate_density_u8_pallas(time, 16, tile_z=8, tile_y=8))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (16, 16, 16)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert got.numpy().max() > 100  # the cloud is there


def test_generate_density_u8_is_quantized_alpha():
    """K8's plain version is the fbm alpha at voxel centres, clipped and
    rounded, whatever its z-slabs (a 1-slice slab size here)."""
    d = 12
    c = (np.arange(d, dtype=np.float32) - d / 2.0) / d
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    sin_t = torch.sin(torch.tensor(0.9, dtype=torch.float32))
    _, alpha = fields_soa.noise_volume(*(torch.from_numpy(np.ascontiguousarray(v))
                                         for v in (x, y, z)), sin_t)
    want = torch.clamp(alpha * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    orig = genvol._SLAB_VOXELS
    try:
        genvol._SLAB_VOXELS = d * d
        got = genvol.generate_density_u8_plain(0.9, d, "cpu")
    finally:
        genvol._SLAB_VOXELS = orig
    assert torch.equal(got, want)
    assert torch.equal(genvol.generate_density_u8(0.9, d, "cpu"), want)


def test_genvol_wrappers_on_cpu_count_nothing():
    """On the CPU the wrappers take the plain versions and launch nothing;
    a bad dims raises."""
    before = (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY)
    t = torch.tensor(0.3)
    d, n = genvol.generate_xor_volumes(t, 8)  # the time tensor's device
    assert d.device.type == "cpu"
    genvol.generate_density_u8(0.3, 8, "cpu")
    assert (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY) == before
    with pytest.raises(ValueError):
        genvol.generate_density_u8(0.3, 0, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("time", [0.0, 1.25, math.pi / 2, -math.pi / 2])
def test_genvol_kernels_match_plain_on_gpu(cuda_device, time):
    """K9 and K8 bitwise equal to their plain versions on the card (the
    kernels read the table that the plain sine hash filled there;
    --fmad=false), at sin t = 0, 0.95 and +-1, at dims that are not
    multiples of the bricks (96, 100; 98 also not of K8's 4-voxel stores),
    and K8 at config 5's 512."""
    before = (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY)
    for dims in (96, 100):
        d, n = genvol.generate_xor_volumes(time, dims, cuda_device)
        d_p, n_p = genvol.generate_xor_volumes_plain(time, dims, cuda_device)
        assert torch.equal(d, d_p) and torch.equal(n, n_p), dims
    for dims in (96, 98, 100, 512):
        v = genvol.generate_density_u8(time, dims, cuda_device)
        assert torch.equal(v, genvol.generate_density_u8_plain(time, dims, cuda_device)), dims
    assert (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY) == (before[0] + 2, before[1] + 4)
