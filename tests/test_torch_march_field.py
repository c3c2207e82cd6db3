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

Tests marked ``gpu`` need a CUDA card and skip without one: they launch K7
and hold it bitwise against its plain version on the same inputs.
"""

import importlib

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import Camera, CameraUniform
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
    """A table that misses most of octave 0's lattice arguments makes K7
    trap; the stream's synchronization raises (in a process of its own: the
    CUDA context is lost)."""
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
        "rays = mf.field_rays(Camera.xor(1.0).uniform(dev), 32, 32)\n"
        "mf.launch(mf.time_vector(0.0, dev), rays, 'noise', 'xor', 256, True, 348,\n"
        "          'analytic', 8, table=bad)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError:\n"
        "    sys.exit(3)\n"
    )
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, proc.stdout + proc.stderr
