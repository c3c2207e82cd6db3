"""K7, the field march (vokselis_torch.ops.cuda.march_field), and the
compute-path oracles (vokselis_torch.ops.reference.render_compute_inline,
render_compute_tex, render_field) against the JAX package, on the CPU.

On the CPU render_field takes K7's plain version. These tests hold it
against the JAX package's render_field_pallas run in interpret mode (as
tests/test_pallas.py runs it) across the combinations of
test_pallas.py:41-77 and :221-272, and against the port's own oracles; and
the port's oracles against the JAX oracles. Tolerances hold means and high
quantiles, not the max: PyTorch's and XLA's CPU sines differ by one ulp on
~2 % of the hash's arguments, which fract(sin(n) * 43758.5453123) turns into
rare per-sample differences up to ~1 (test_torch_fields.py). Camera uniforms
are carried across from the JAX camera with CameraUniform.from_numpy.

Tests marked ``gpu`` need a CUDA card and skip without one: they launch K7,
which makes its own rays from the camera, and hold it bitwise against its
plain version on the same inputs: the ray planes of field_rays marched by
the plain march.
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine import profiler
from vokselis_torch.models.xor import FieldPipeline
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda import genvol
from vokselis_torch.ops.cuda import march_field as mf
from vokselis_torch.volume import fields, fields_soa

# (field, shading, quantize, grad) of test_pallas.py:41-77 and :221-272
COMBOS = {
    "noise-xor-fd": ("noise", "xor", True, "fd"),
    "noise-xor-analytic": ("noise", "xor", True, "analytic"),
    "trig-emission": ("trig", "emission", False, "fd"),
    "xor-xor": ("xor", "xor", True, "fd"),
}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_march_field():
    """The JAX package's march_field module with every pallas_call in
    interpret mode (test_pallas.py:16-38), reloaded back afterwards."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    name = "vokselis_tpu.ops.pallas.march_field"
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


def _uniforms(aspect=1.0):
    """The JAX xor camera's uniform and the same arrays carried across."""
    from vokselis_tpu.core.camera import Camera as JaxCamera

    ju = JaxCamera.xor(aspect).uniform()
    return ju, CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                        np.asarray(ju.inv_proj), "cpu")


def _close(port, ref, mean, q99):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    d = np.abs(port - np.asarray(ref))
    assert np.isfinite(port).all()
    assert d.mean() <= mean, f"mean {d.mean():.3e} > {mean:g}"
    assert np.quantile(d, 0.99) <= q99, f"q99 {np.quantile(d, 0.99):.3e} > {q99:g}"


# -- K7's plain version --------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True], ids=["capped", "sphere-clip"])
@pytest.mark.parametrize("time", [0.0, 1.7])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_render_field_plain_matches_jax_kernel(jax_march_field, combo, time, clip):
    """The plain version against render_field_pallas in interpret mode at
    32x32: 32 steps without the clip (test_pallas.py:41-77, :221-249), the
    full march with it (:252-272, where the clip is exact only when both
    paths march to completion). Bounds: noise and trig mean <= 1e-5 and
    99th percentile <= 1e-3 (measured <= 1.6e-6 / 5e-5); the bitwise xor
    field, whose normals are the noise field's one-sided differences at
    lattice coordinates where its value jumps, mean <= 1e-4 and 99th
    percentile <= 5e-3 (test_pallas.py:248-249's bounds; measured 2.5e-5 /
    4.4e-4)."""
    field, shading, quantize, grad = COMBOS[combo]
    ju, u = _uniforms()
    kw = dict(width=32, height=32, field=field, shading=shading, quantize=quantize,
              max_steps=reference.MAX_STEPS_COMPUTE if clip else 32, sphere_clip=clip,
              grad=grad)
    port = mf.render_field(u, time, **kw)
    ref = jax_march_field.render_field_pallas(ju, time, tile_h=16, tile_w=128, **kw)
    assert port.shape == (32, 32, 4) and port.dtype == torch.float32
    if field == "xor":
        _close(port, ref, mean=1e-4, q99=5e-3)
    else:
        _close(port, ref, mean=1e-5, q99=1e-3)
    if clip:  # the full march reaches the field (32 steps stop short of it)
        assert float(port[..., :3].max()) > 0.03


@pytest.mark.parametrize("time", [0.0, 1.7])
def test_render_field_plain_matches_port_oracles(time):
    """Inside the port, the plain march with grad="fd" and no clip repeats
    the oracles' samples: bitwise render_compute_inline over 32 steps (the
    fused hash-shared normal is bitwise the oracle's five evaluations, up
    to the AoS norm's summation, which gives <= 1e-6), and render_field for
    the trig field; with the clip and the full march, within 1e-5 mean
    (the clip is exact empty-space skipping; the entry snap rounds t)."""
    _, u = _uniforms()
    inline = reference.render_compute_inline(u, time, width=32, height=32, max_steps=32)
    plain = mf.render_field_plain(u, time, 32, 32, max_steps=32, sphere_clip=False, grad="fd")
    np.testing.assert_allclose(plain.numpy(), inline.numpy(), rtol=0, atol=1e-6)
    trig = reference.render_field(u, time, width=32, height=32, max_steps=32)
    plain_t = mf.render_field_plain(u, time, 32, 32, field="trig", shading="emission",
                                    quantize=False, max_steps=32, sphere_clip=False)
    np.testing.assert_allclose(plain_t.numpy(), trig.numpy(), rtol=0, atol=1e-6)
    full = reference.render_compute_inline(u, time, width=24, height=24)
    clipped = mf.render_field_plain(u, time, 24, 24, grad="fd")
    _close(clipped, full, mean=1e-5, q99=1e-3)


def test_analytic_grad_frame_close_to_fd():
    """test_fields.py:54-68 in the port: the analytic-gradient frame sits
    well inside the 1e-3 budget against the fd frame (mean < 3e-4)."""
    _, u = _uniforms()
    kw = dict(width=32, height=32, max_steps=64)
    fd = mf.render_field(u, 0.7, grad="fd", **kw)
    an = mf.render_field(u, 0.7, grad="analytic", **kw)
    d = (an[..., :3] - fd[..., :3]).abs()
    assert float(d.mean()) < 3e-4, float(d.mean())
    assert not torch.equal(an, fd)


def test_grad_default_follows_env(monkeypatch):
    monkeypatch.delenv("VOK_XOR_GRAD", raising=False)
    assert mf.default_grad() == "analytic"
    monkeypatch.setenv("VOK_XOR_GRAD", "fd")
    assert mf.default_grad() == "fd"
    _, u = _uniforms()
    kw = dict(width=16, height=16, max_steps=48)
    assert torch.equal(mf.render_field(u, 0.2, **kw), mf.render_field(u, 0.2, grad="fd", **kw))
    monkeypatch.setenv("VOK_XOR_GRAD", "central")
    with pytest.raises(ValueError):
        mf.render_field(u, 0.2, **kw)


def test_tile_h_and_time_tensor_change_nothing():
    """tile_h (the xor demo's F1 toggle) sets only the kernel's block rows;
    a 0-d time tensor equals the Python float; a bad tile_h raises; on the
    CPU nothing launches."""
    _, u = _uniforms(16 / 9)
    before = mf.LAUNCHES_FIELD
    a = mf.render_field(u, 0.5, 40, 24, tile_h=8, max_steps=64)
    b = mf.render_field(u, torch.tensor(0.5), 40, 24, tile_h=16, max_steps=64)
    assert torch.equal(a, b)
    assert mf.LAUNCHES_FIELD == before
    for bad in (dict(tile_h=12), dict(field="fog"), dict(shading="phong"), dict(dims=0),
                dict(max_steps=-1)):
        with pytest.raises(ValueError):
            mf.render_field(u, 0.5, 8, 8, **bad)


def test_plain_return_steps_counts_samples():
    """return_steps counts each ray's samples (the kernel's work): zero on
    misses and outside the sphere, at most max_steps, and the image is the
    same."""
    _, u = _uniforms()
    img, steps = mf.render_field_plain(u, 0.0, 32, 32, max_steps=100, return_steps=True)
    assert torch.equal(img, mf.render_field_plain(u, 0.0, 32, 32, max_steps=100))
    assert steps.dtype == torch.int32 and steps.shape == (32, 32)
    assert int(steps.max()) <= 100 and int(steps[0, 0]) == 0 and int(steps.sum()) > 0


# -- K7 making its own rays: the frame wrapper ------------------------------------------

# (field, shading, grad): one per kernel instantiation
VARIANTS = {
    "noise-xor-analytic": ("noise", "xor", "analytic"),
    "noise-xor-fd": ("noise", "xor", "fd"),
    "noise-emission": ("noise", "emission", "fd"),
    "xor-xor": ("xor", "xor", "fd"),
    "xor-emission": ("xor", "emission", "fd"),
    "trig-xor": ("trig", "xor", "fd"),
    "trig-emission": ("trig", "emission", "fd"),
}
# around the xor demo's target: the field-orbit's zoom range, an axis-aligned
# view (a zero direction component: infinite slab terms), the eye in the box
FIELD_POSES = {
    "zoom1.2": dict(zoom=1.2, pitch=0.3, yaw=0.8),
    "zoom2.4": dict(zoom=2.4, pitch=-0.5, yaw=2.0),
    "axis": dict(zoom=2.0, pitch=0.0, yaw=0.0),
    "inside": dict(zoom=0.8, pitch=0.2, yaw=1.3),
}


def _field_uniform(pose, aspect, device):
    return Camera(aspect=aspect, target=(0.0, 0.0, 0.0), **FIELD_POSES[pose]).uniform(device)


@pytest.mark.parametrize("clip", [True, False], ids=["sphere-clip", "box"])
@pytest.mark.parametrize("quantize", [True, False], ids=["quantized", "exact"])
@pytest.mark.parametrize("variant", ["noise-xor-analytic", "xor-xor", "trig-emission"])
def test_render_field_on_the_cpu_is_the_plain_twin(variant, quantize, clip, monkeypatch):
    """On the CPU render_field is field_rays and time_vector marched by the
    plain march, bitwise, for each field with quantization and the sphere
    clip on and off; nothing is built or launched."""
    def no_build():
        raise AssertionError("the CPU path built a kernel")

    monkeypatch.setattr(mf, "build", no_build)
    field, shading, grad = VARIANTS[variant]
    u = _field_uniform("zoom1.2", 24 / 16, "cpu")
    rays = mf.field_rays(u, 24, 16, field, 256, quantize, clip)
    want = mf._march_plain(mf.time_vector(1.7, "cpu"), rays, field, shading, 256, quantize, 96,
                           grad)
    before = mf.LAUNCHES_FIELD
    got = mf.render_field(u, 1.7, 24, 16, field=field, shading=shading, quantize=quantize,
                          max_steps=96, sphere_clip=clip, grad=grad)
    assert torch.equal(got, want)
    assert mf.LAUNCHES_FIELD == before
    assert float(got[..., :3].max()) > 0.03


def test_inline_rays_counter_absent_on_the_cpu():
    """``k7.inline_rays`` counts rays that K7 makes on a card: a CPU frame,
    through the xor pipeline or FieldRenderer, adds none (the pipeline's
    ``field.rays`` still counts)."""
    u = _field_uniform("zoom2.4", 1.0, "cpu")
    with profiler.recording() as rec:
        FieldPipeline("cpu").render(u, 0.0, 12, 8)
        mf.FieldRenderer("cpu")(u, 0.0, 12, 8, max_steps=32)
    assert rec.counters["field.rays"] == 12 * 8
    assert "k7.inline_rays" not in rec.counters


def _with_inv(inv):
    u = _field_uniform("zoom2.4", 1.0, "cpu")
    return CameraUniform(u.view_position, u.proj_view, inv)


def _inv():
    return _field_uniform("zoom2.4", 1.0, "cpu").inv_proj


BAD_FRAME_INPUTS = {
    "inv_proj_float64": (lambda: (_with_inv(_inv().double()), 0.0), TypeError, "float32"),
    "inv_proj_numpy": (lambda: (_with_inv(_inv().numpy()), 0.0), TypeError, "torch.Tensor"),
    "inv_proj_3x4": (lambda: (_with_inv(_inv()[:3].contiguous()), 0.0), ValueError, r"\(4, 4\)"),
    "inv_proj_batched": (lambda: (_with_inv(_inv()[None]), 0.0), ValueError, r"\(4, 4\)"),
    "inv_proj_not_contiguous": (lambda: (_with_inv(_inv().t()), 0.0), ValueError, "contiguous"),
    "inv_proj_on_the_cpu": (lambda: (_with_inv(_inv()), 0.0), ValueError, "CUDA device"),
    "inv_proj_on_meta": (lambda: (_with_inv(_inv().to("meta")), 0.0), ValueError,
                         "CUDA device"),
    "time_on_another_device": (lambda: (_with_inv(_inv().to("meta")), torch.tensor(0.5)),
                               ValueError, "time is on cpu"),
    "time_on_the_cpu": (lambda: (_with_inv(_inv()), torch.zeros((), device="meta")),
                        ValueError, "time is on meta"),
    "time_two_values": (lambda: (_with_inv(_inv()), torch.zeros(2)), ValueError, "one value"),
    "time_string": (lambda: (_with_inv(_inv()), "0.5"), TypeError, "number"),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAME_INPUTS))
def test_frame_wrapper_rejects_bad_inputs(case, monkeypatch):
    """The frame wrapper refuses what K7 could not read as its camera and
    time (inv_proj's type, dtype, shape, contiguity and device; a time on
    another device, of more than one value, or of another type) before it
    builds, reads the hash table or launches anything."""
    class StandIn:
        def __getattr__(self, name):
            raise AssertionError(f"the stand-in library's {name} was reached")

    def no_build(*args):
        raise AssertionError("built before the inputs were checked")

    monkeypatch.setattr(mf, "build", no_build)
    monkeypatch.setattr(mf, "hash_table", no_build)
    make, exc, match = BAD_FRAME_INPUTS[case]
    u, t = make()
    before = mf.LAUNCHES_FIELD
    with pytest.raises(exc, match=match):
        mf.launch(u, t, 8, 8, "noise", "xor", 256, True, 32, "analytic", 8, lib=StandIn())
    assert mf.LAUNCHES_FIELD == before


def test_sphere_radius_is_field_rays_radius():
    """The squared radius the kernel receives is field_rays' Python float:
    the field's radius plus the texel pad when quantized, 1e9 unclipped."""
    assert mf._sphere_r2("noise", 256, True, True) == (1.0 + 2.0 * np.sqrt(3.0) / 256) ** 2
    assert mf._sphere_r2("xor", 256, False, True) == 1.4 ** 2
    assert mf._sphere_r2("trig", 16, False, False) == 1e9 ** 2
    assert np.float32(mf._sphere_r2("trig", 16, True, False)) == np.float32(1e18)


# -- the port's oracles ------------------------------------------------------------------

@pytest.mark.parametrize("time", [0.0, 1.7])
def test_oracles_match_jax_oracles(time):
    """render_compute_inline (fbm and xor fields) and render_field (trig)
    against the JAX oracles at 32 steps: noise and trig mean <= 1e-5, 99th
    percentile <= 1e-3; the xor field mean <= 1e-4, 99th percentile <= 5e-3
    (as for the plain version)."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops import reference as jref
    from vokselis_tpu.volume import fields as jfields

    ju, u = _uniforms()
    kw = dict(width=32, height=32, max_steps=32)
    _close(reference.render_compute_inline(u, time, **kw),
           jref.render_compute_inline(ju, time, **kw), mean=1e-5, q99=1e-3)
    _close(reference.render_compute_inline(u, time, field=fields.xor_field, **kw),
           jref.render_compute_inline(ju, time, field=jfields.xor_field, **kw),
           mean=1e-4, q99=5e-3)
    _close(reference.render_field(u, time, **kw), jref.render_field(ju, time, **kw),
           mean=1e-5, q99=1e-3)


def test_render_compute_tex_matches_jax_and_inline():
    """render_compute_tex over K9's volumes (the plain version on the CPU)
    against the JAX texture oracle over the JAX volumes, and against the
    port's inline oracle with test_render_oracle.py:70-84's bounds: max <
    5e-3, >= 97 % of components within 1e-5, mean < 5e-6. Against the JAX
    frame the volumes themselves differ by the hash (test_torch_fields.py's
    K9 bounds), so the frame is held at mean <= 1e-4, 99th percentile <=
    1e-3 (measured 1.6e-5 mean)."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops import reference as jref
    from vokselis_tpu.volume import fields as jfields

    dims = 32
    ju, u = _uniforms()
    dens, nrm = genvol.generate_xor_volumes(0.0, dims, "cpu")
    tex = reference.render_compute_tex(dens, nrm, u, width=48, height=48)
    inline = reference.render_compute_inline(u, width=48, height=48, dims=dims)
    err = (tex - inline).abs().numpy()
    assert err.max() < 5e-3
    assert (err < 1e-5).mean() > 0.97
    assert err.mean() < 5e-6
    jd, jn = jfields.generate_xor_volumes(dims, time=0.0)
    jtex = jref.render_compute_tex(jd, jn, ju, width=48, height=48)
    _close(tex, jtex, mean=1e-4, q99=1e-3)


def test_miss_pixels_and_initial_alpha():
    """test_render_oracle.py:86-106 in the port: misses return the clear
    colour, and a ray through an empty field keeps (clear.rgb, 1) — get_col2
    starts at alpha 0.1 (raycast_compute.wgsl:61)."""
    _, u = _uniforms()
    img = reference.render_compute_inline(u, width=32, height=32, dims=8, max_steps=8)
    np.testing.assert_allclose(img[0, 0].numpy(), [0.023, 0.02, 0.02, 1.0], atol=1e-6)

    def empty_field(coord, time):
        v = torch.zeros_like(coord[..., 0])
        return torch.stack([v, v, v, v], dim=-1)

    img = reference.render_compute_inline(u, width=16, height=16, dims=8, max_steps=8,
                                          field=empty_field)
    np.testing.assert_allclose(img[8, 8].numpy(), [0.023, 0.02, 0.02, 1.0], atol=1e-6)
    k7 = mf.render_field(u, 0.0, 32, 32, max_steps=8)
    np.testing.assert_allclose(k7[0, 0].numpy(), [0.023, 0.02, 0.02, 1.0], atol=1e-6)


# -- K7's hash table ----------------------------------------------------------------------

def test_hash_table_is_the_plain_hash():
    """The table holds fields_soa.hash_ of every integer of each octave's
    range, bitwise (the f32 arange is exact: the values are integers below
    2^24), at the documented ranges."""
    assert mf.HASH_RANGES == ((66397, 85653), (133900, 171555), (270852, 346049))
    table = mf.build_hash_table("cpu")
    assert table.values.dtype == torch.float32 and table.values.numel() == 132111
    for o, (lo, hi) in enumerate(mf.HASH_RANGES):
        n = torch.arange(lo, hi + 1, dtype=torch.int64).to(torch.float32)
        assert torch.equal(n, torch.arange(lo, hi + 1, dtype=torch.float32))
        got = table.values[table.off[o]:table.off[o] + n.numel()]
        assert torch.equal(got, fields_soa.hash_(n))
        assert table.lo[o] == lo and table.last[o] == hi - lo - 271
    assert mf.hash_table("cpu") is mf.hash_table("cpu")


def _extreme_points():
    """c and sin t at the extremes K7 samples: the box corners (and a
    rounding step past them), the quantized voxel centres nearest the faces
    at dims 256 and 512, each at sin t in {-1, 0, 1}, plus random points."""
    corners = [np.array(c, np.float32) for c in np.ndindex(2, 2, 2)]
    pts = [2.0 * c - 1.0 for c in corners] + [(2.0 * c - 1.0) * np.float32(1 + 1e-5)
                                               for c in corners]
    for dims in (256, 512):
        ends = np.array([0 - dims / 2, dims - 1 - dims / 2], np.float32) / np.float32(dims)
        pts += [ends[list(i)] for i in np.ndindex(2, 2, 2)]
    pts += list(np.random.default_rng(3).uniform(-1, 1, (2000, 3)).astype(np.float32))
    c = torch.from_numpy(np.stack(pts))
    c = c.repeat(3, 1)
    sin_t = torch.tensor([-1.0, 0.0, 1.0]).repeat_interleave(len(pts))
    return c[:, 0], c[:, 1], c[:, 2], sin_t


def _lattice_arguments(cx, cy, cz, sin_t):
    """Per octave, every hash argument n + k the noise field and its normals
    read at these points: the corners of the base cell and of the three
    one-sided offset points' cells (fields_soa.fbm_base/_offsets_from_base,
    noise_volume and gradient)."""
    eps = 1e-4
    x, y, z = fields_soa._lattice(cx, cy, cz, sin_t)
    xe, ye, ze = fields_soa._lattice(cx - eps, cy - eps, cz - eps, sin_t)
    args = []
    for s in (2.01, 2.02, None):
        px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
        pxe, pye, pze = torch.floor(xe), torch.floor(ye), torch.floor(ze)
        cells = (px + py * 157.0 + 113.0 * pz, pxe + py * 157.0 + 113.0 * pz,
                 px + pye * 157.0 + 113.0 * pz, px + py * 157.0 + 113.0 * pze)
        args.append(torch.cat([n + k for n in cells for k in fields_soa._CORNERS]))
        if s is not None:
            x, y, z, xe, ye, ze = x * s, y * s, z * s, xe * s, ye * s, ze * s
    return args


def test_table_hash_at_the_extreme_lattice_points():
    """A plain table read, fed every lattice argument the extreme points
    reach, equals the direct hash bitwise, and every argument lies inside
    its octave's range (so the kernel never traps on the field's domain)."""
    table = mf.build_hash_table("cpu")
    for o, n in enumerate(_lattice_arguments(*_extreme_points())):
        lo, hi = mf.HASH_RANGES[o]
        assert float(n.min()) >= lo and float(n.max()) <= hi, (o, float(n.min()), float(n.max()))
        assert torch.equal(n, torch.round(n))
        assert torch.equal(mf.table_hash(table, o, n), fields_soa.hash_(n))


def test_table_hash_raises_outside_its_range():
    table = mf.build_hash_table("cpu")
    (lo, hi), _, _ = mf.HASH_RANGES
    for n in (lo - 1.0, hi + 1.0, float("nan")):
        with pytest.raises(IndexError):
            mf.table_hash(table, 0, torch.tensor([float(lo), n]))


# -- K7 on the card -----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("time", [0.0, 1.7])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_kernel_matches_plain_on_gpu(cuda_device, combo, time):
    """K7 bitwise equal to its plain version on the card at 96x64, with and
    without the sphere clip, and each launch counted once."""
    field, shading, quantize, grad = COMBOS[combo]
    u = Camera.xor(1.5).uniform(cuda_device)
    for clip in (True, False):
        kw = dict(field=field, shading=shading, quantize=quantize, sphere_clip=clip,
                  grad=grad)
        before = mf.LAUNCHES_FIELD
        k = mf.render_field(u, time, 96, 64, **kw)
        torch.cuda.synchronize()
        assert mf.LAUNCHES_FIELD == before + 1
        p = mf.render_field_plain(u, time, 96, 64, **kw)
        assert torch.equal(k, p), float((k - p).abs().max())
        assert torch.equal(k, mf.render_field(u, time, 96, 64, tile_h=1, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("analytic", 0.0, 256, 256), ("fd", 1.7, 160, 90)])
def test_table_hash_kernel_bitwise_on_gpu(cuda_device, case):
    """K7 with its hash table, bit for bit its plain version (which takes
    the sine hash) at two inputs; the table built on the card is the
    plain hash there too."""
    grad, time, w, h = case
    table = mf.hash_table(cuda_device)
    lo, hi = mf.HASH_RANGES[2]
    n = torch.arange(lo, hi + 1, dtype=torch.float32, device=cuda_device)
    assert torch.equal(table.values[table.off[2]:], fields_soa.hash_(n))
    u = Camera.xor(w / h).uniform(cuda_device)
    k = mf.render_field(u, time, w, h, grad=grad)
    assert torch.equal(k, mf.render_field_plain(u, time, w, h, grad=grad))


@pytest.mark.gpu
def test_out_of_range_table_traps_on_gpu(cuda_device):
    """A table that misses most of octave 0's lattice arguments makes K7,
    making its own rays, trap; the stream's synchronization raises (in a
    process of its own: the CUDA context is lost)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from vokselis_torch.core.camera import Camera\n"
        "from vokselis_torch.ops.cuda import march_field as mf\n"
        "dev = torch.device('cuda', 0)\n"
        "(lo, _), *rest = mf.HASH_RANGES\n"
        "bad = mf.build_hash_table(dev, ((lo, lo + 300), *rest))\n"
        "mf.launch(Camera.xor(1.0).uniform(dev), 0.0, 32, 32, 'noise', 'xor', 256, True,\n"
        "          348, 'analytic', 8, table=bad)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError:\n"
        "    sys.exit(3)\n"
    )
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, proc.stdout + proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(1280, 720), (97, 61), (512, 512)],
                         ids=["1280x720", "97x61", "512x512"])
def test_inline_frame_is_bitwise_the_plane_frame_on_gpu(cuda_device, size):
    """K7 making its own rays gives the plane frame (render_field_plain on
    the card: field_rays' planes marched in torch) bit for bit at the xor
    demo's settings, at zoom 1.2 and 2.4, an axis-aligned view and the eye
    in the box, at tile_h 8 and 16 (partial 32x8 and 32x16 blocks on both
    axes at 97x61), the time a Python float and a 0-d tensor."""
    w, h = size
    for i, pose in enumerate(FIELD_POSES):
        u = _field_uniform(pose, w / h, cuda_device)
        t = 1.7 if i % 2 else torch.full((), 0.4, device=cuda_device)
        want = mf.render_field_plain(u, t, w, h, grad="analytic")
        for tile_h in (8, 16):
            got = mf.render_field(u, t, w, h, grad="analytic", tile_h=tile_h)
            assert torch.equal(got, want), (pose, tile_h, float((got - want).abs().max()))
        lit = (want[..., :3] - want.new_tensor(mf._CLEAR[:3])).abs().amax(dim=-1) > 1e-3
        assert float(lit.float().mean()) > 0.005, pose


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_inline_frame_every_variant_bitwise_on_gpu(cuda_device, variant):
    """Each field, shading and normal source, with quantization and the
    sphere clip on and off: K7 making its own rays is the plane frame bit for
    bit at 97x61, at zoom 1.2 and with the eye in the box."""
    field, shading, grad = VARIANTS[variant]
    for pose in ("zoom1.2", "inside"):
        u = _field_uniform(pose, 97 / 61, cuda_device)
        for quantize in (True, False):
            for clip in (True, False):
                kw = dict(field=field, shading=shading, quantize=quantize, sphere_clip=clip,
                          grad=grad)
                got = mf.render_field(u, 1.7, 97, 61, **kw)
                want = mf.render_field_plain(u, 1.7, 97, 61, **kw)
                assert torch.equal(got, want), (pose, quantize, clip,
                                                float((got - want).abs().max()))


@pytest.mark.gpu
def test_field_pipeline_graph_holds_k7_alone_on_gpu(cuda_device):
    """The xor pipeline's and FieldRenderer's captured frames are one kernel
    node each, K7: no elementwise ray kernel is left in front of it."""
    u = _field_uniform("zoom2.4", 64 / 48, cuda_device)
    t = torch.full((), 0.4, device=cuda_device)
    pipe = FieldPipeline(cuda_device, grad="analytic")
    fr = mf.FieldRenderer(cuda_device)
    for compiled, call in ((pipe.compiled, lambda: pipe.render(u, t, 64, 48)),
                           (fr.compiled, lambda: fr(u, t, 64, 48, grad="analytic"))):
        first = call()
        graph = compiled.graph(compiled.keys()[-1])
        names = profiler._node_names(profiler._driver(), ctypes.c_void_p(graph.raw_cuda_graph()))
        assert len(names) == 1 and profiler.kernel_name_matches(names[0],
                                                                "march_field_kernel"), names
        assert torch.equal(call(), first)
        assert torch.equal(first, mf.render_field_plain(u, t, 64, 48, grad="analytic"))


@pytest.mark.gpu
def test_inline_rays_counter_on_gpu(cuda_device):
    """On a card every call of the xor pipeline or FieldRenderer, captured or
    replayed, adds width x height to ``k7.inline_rays``."""
    u = _field_uniform("zoom1.2", 40 / 24, cuda_device)
    pipe = FieldPipeline(cuda_device)
    fr = mf.FieldRenderer(cuda_device)
    with profiler.recording() as rec:
        for _ in range(3):
            pipe.render(u, 0.0, 40, 24)
        fr(u, 0.0, 40, 24)
        fr(u, 0.0, 40, 24)
    torch.cuda.synchronize()
    assert rec.counters["k7.inline_rays"] == 5 * 40 * 24
    assert rec.counters["field.rays"] == 3 * 40 * 24
