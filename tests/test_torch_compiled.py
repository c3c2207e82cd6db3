"""The port's compiled frames (vokselis_torch.engine.compiled: the counterpart
of jax.jit's trace cache) and the camera uniform's host mirrors.

On the CPU a compiled entry runs the eager function it wraps and records its
static key, so these tests hold every entry bitwise against that function
(the exact, fast and field frames, the hybrid on each route and its
functional builder, the trig raster, present and config 5's batch step),
each also against the JAX package's frame within the tolerance the existing
test_torch_* file uses for it, and the keys: a new uniform or a new time
reuses a key, a new width, intermediate, budget or srgb makes one.

The host mirrors: ``Camera.uniform().host_np`` is bitwise the JAX package's,
and ``pose_hint`` and the hybrid's route read them and no device value (the
uniform's tensors are moved to the ``meta`` device, where any read raises).
The glue of every frame (rays, the fast geometry, the warp coordinates,
curvature, scoring, selection, compact rays, the degeneracy flag, the field
rays, the time vector and present) runs on ``meta`` tensors too: a host read
would raise there, and one would also fail a CUDA graph's capture.

Tests marked ``gpu`` need a CUDA card and skip without one: each entry's
replays at three poses (the fast frame's dominant axis and marching sign
change between them) and two times, bitwise equal to the eager call and
free of host syncs, and a capture that fails raising. On the card run
``python -m pytest tests/test_torch_compiled.py --noconftest -m gpu``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine.compiled import CompiledFrame
from vokselis_torch.engine.context import Context, Presenter
from vokselis_torch.models.trig import TrigDemo, trig_frame
from vokselis_torch.models.views import ViewsBatch
from vokselis_torch.models.xor import FieldPipeline
from vokselis_torch.ops import hybrid as hy
from vokselis_torch.ops import shear_warp
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.ops.cuda import march_field as mf
from vokselis_torch.ops.present import FILTERS, present, to_uint8
from vokselis_torch.volume.io import dense_stress, get_bonsai

TARGET = (0.5, 0.5, 0.5)
# the fast frame's (m, sgn) at 96x54, I=64: (0, +1), (2, -1), (1, +1)
POSES = {
    "bench": dict(zoom=1.0, pitch=0.5, yaw=1.0, target=TARGET),
    "yaw3": dict(zoom=1.0, pitch=0.5, yaw=3.0, target=TARGET),
    "top": dict(zoom=1.0, pitch=1.2, yaw=0.3, target=TARGET),
}
W, H = 64, 36
META = torch.device("meta")


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


def _carried(ju, device="cpu"):
    """The JAX camera's uniform arrays carried across (a one-ulp difference
    in inv_proj moves far-plane rays ~3e-4)."""
    return CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                    np.asarray(ju.inv_proj), device)


def _jax_camera_class():
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera

    return JaxCamera


def _jax_camera(**kw):
    return _jax_camera_class()(**kw)


@pytest.fixture
def jax_interpreted():
    """``load(*names)``: the JAX modules reloaded, in order, with every
    pallas_call in interpret mode (test_pallas.py:16-38) for the test; they
    are reloaded back afterwards."""
    pytest.importorskip("jax")
    import importlib

    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    loaded = []

    def load(*names):
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        loaded.extend(names)
        return [importlib.reload(importlib.import_module(n)) for n in names]

    try:
        yield load
    finally:
        pl.pallas_call = orig
        for name in loaded:
            importlib.reload(importlib.import_module(name))


# -- the host mirrors ----------------------------------------------------------------------

MIRROR_POSES = {"bench": ("bonsai", {}), "xor": ("xor", {})}
MIRROR_POSES.update({f"orbit{i}": (None, dict(zoom=1.0, pitch=0.5, yaw=2.0 * math.pi * i / 8,
                                              target=TARGET, aspect=1920 / 1080))
                     for i in range(8)})


@pytest.mark.parametrize("pose", list(MIRROR_POSES))
def test_uniform_host_mirrors_match_jax(pose):
    """Camera.uniform().host_np is bitwise the JAX package's
    (vokselis_tpu/core/camera.py:168-183) at the bench pose, Camera.xor and
    config 4's 8 orbit poses, and the tensors hold the same values."""
    pytest.importorskip("jax")
    from vokselis_tpu.core.camera import Camera as JaxCamera

    preset, kw = MIRROR_POSES[pose]
    if preset is None:
        cam, jcam = Camera(**kw), JaxCamera(**kw)
    else:
        cam, jcam = getattr(Camera, preset)(16 / 9), getattr(JaxCamera, preset)(16 / 9)
    u, ju = cam.uniform("cpu"), jcam.uniform()
    assert u.host_np is not None and len(u.host_np) == 3
    for port, ref, t in zip(u.host_np, ju.host_np, u.tensors()):
        assert port.dtype == ref.dtype == np.float32 and port.shape == ref.shape
        assert port.tobytes() == ref.tobytes()
        assert t.numpy().tobytes() == ref.tobytes()


def test_rebuilt_uniforms_have_no_mirrors():
    """from_numpy, stack, indexing and iteration give uniforms without host
    mirrors, as the JAX package's rebuilt uniforms lack them."""
    u = Camera.bonsai(1.0).uniform("cpu")
    rebuilt = [CameraUniform.from_numpy(*u.host_np, "cpu"), CameraUniform.identity("cpu")]
    batch = CameraUniform.stack([u, Camera.xor(1.0).uniform("cpu")])
    rebuilt += [batch, batch[0], batch[0:1], *batch]
    assert all(r.host_np is None for r in rebuilt)
    assert torch.equal(batch[0].inv_proj, u.inv_proj)


def _meta_uniform(cam):
    """``cam``'s uniform with its tensors on the meta device and its host
    mirrors kept: any device read raises."""
    u = cam.uniform("cpu")
    m = CameraUniform(*(t.to(META) for t in u.tensors()))
    m.host_np = u.host_np
    return m


@pytest.mark.parametrize("pitch", [0.5, -0.35, 1.2])
def test_pose_hint_reads_only_the_mirrors(pitch):
    """pose_hint on a uniform whose tensors lie on the meta device returns
    what the JAX package's pose_hint returns, at the 72-pose grid's zoom 1.0
    row (tools/cpu_minisweep.py:67-69), 256^2, I=256: no device read is
    left."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.shear_warp import pose_hint as jax_pose_hint

    for i in range(8):
        kw = dict(zoom=1.0, pitch=pitch, yaw=2 * math.pi * i / 8, target=TARGET, aspect=1.0)
        shear_warp._HINT_CACHE.clear()
        got = shear_warp.pose_hint(_meta_uniform(Camera(**kw)), 256, 256, 256, 256)
        assert got == jax_pose_hint(_jax_camera(**kw).uniform(), 256, 256, 256, 256), i
    with pytest.raises((NotImplementedError, RuntimeError)):
        shear_warp.pose_hint(CameraUniform(*_meta_uniform(Camera.bonsai(1.0)).tensors()),
                             256, 256, 256, 256)


def test_route_reads_no_device_value():
    """The hybrid's route on a Camera.uniform() uniform reads its host
    mirrors: the same route with the tensors on the meta device, at a
    hybrid pose and at one that escalates or falls back."""
    r = hy.HybridBonsaiRenderer(get_bonsai(64), "cpu", intermediate=128, budget=3)
    for cam in (Camera.bonsai(16 / 9),
                Camera(zoom=0.6, pitch=1.2, yaw=0.0, target=TARGET, aspect=16 / 9)):
        shear_warp._HINT_CACHE.clear()
        want = r.route(cam.uniform("cpu"), 160, 90)
        shear_warp._HINT_CACHE.clear()
        assert r.route(_meta_uniform(cam), 160, 90) == want
    assert want[0] != "hybrid"


def test_context_update_reads_nothing_back():
    """Context.update and a camera change upload the per-frame globals and
    the camera uniform without reading the device (a meta context runs
    them), and on the CPU they hold the values given."""
    ctx = Context(W, H, device=META)
    ctx.input.update_key("up", True)
    ctx.update(time_delta=0.25, time=1.5)
    ctx.camera.add_yaw(0.3)
    ctx.update(time_delta=0.25, time=1.75)
    assert ctx.global_uniform.time.device == META and ctx.camera_uniform.host_np is not None
    cpu = Context(W, H, device="cpu")
    cpu.input.update_key("up", True)
    cpu.input.update_mouse_pos(16.0, 9.0, W, H)
    cpu.update(time_delta=0.25, time=1.5)
    g = cpu.global_uniform
    assert float(g.time) == 1.5 and float(g.time_delta) == 0.25 and int(g.frame) == 0
    assert g.frame.dtype == torch.uint32 and g.resolution.tolist() == [1280.0, 720.0]
    assert g.pos.tolist() == pytest.approx([0.0, 0.01, 0.0]) and g.mouse.tolist() == [-0.5, 0.5]


# -- the glue on meta tensors ------------------------------------------------------------------

def _meta_geometry():
    pack = shear_warp.prepare_fast_volume(get_bonsai(32), "cpu")
    mpack = (pack[0].to(META), tuple(t.to(META) for t in pack[1]))
    return shear_warp.fast_geometry(mpack, _meta_uniform(Camera.bonsai(16 / 9)), W, H, 64)


GLUE = {
    "rays_fragment_soa": lambda u: geometry.rays_fragment_soa(u, W, H),
    "fast_geometry": lambda u: _meta_geometry(),
    "warp_coords": lambda u: shear_warp.warp_coords(_meta_geometry(), 64, 64),
    "curvature": lambda u: shear_warp.curvature(torch.empty((4, 64, 64), device=META)),
    "score_tiles": lambda u: hy.score_tiles(torch.empty((6, 5), device=META), 2, 3),
    "select_units": lambda u: (hy.select_units(torch.empty(6, device=META), 6, 4, 1e-3, False),
                               hy.select_units(torch.empty(6, device=META), 6, 4, 1e-3, True)),
    "tile_rays_compact": lambda u: mb.tile_rays_compact(
        u, torch.zeros(2, dtype=torch.int32, device=META), W, H, 2),
    "traced_degenerate": lambda u: shear_warp.traced_degenerate(u, 256),
    "field_rays": lambda u: mf.field_rays(u, W, H),
    "time_vector": lambda u: mf.time_vector(torch.zeros((), device=META), META),
    "present": lambda u: [present(torch.empty((H, W, 4), device=META), 2 * H, 2 * W, filter=f)
                          for f in FILTERS],
}


def _leaves(x):
    """The tensors of an output: a tensor, a tuple or list, or a dataclass
    (FastGeometry)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [t for y in x for t in _leaves(y)] if isinstance(x, (tuple, list)) else []


@pytest.mark.parametrize("name", list(GLUE))
def test_glue_runs_on_meta_tensors(name):
    """Every op of a frame's glue has a meta kernel and reads no value on
    the host: the CPU's guard that a frame can be captured."""
    tensors = _leaves(GLUE[name](_meta_uniform(Camera.bonsai(16 / 9))))
    assert tensors and all(t.device == META for t in tensors)


# -- each compiled entry against its eager function and the JAX package ------------------------

def test_exact_entries_are_the_eager_frame_and_match_jax(jax_interpreted):
    """BonsaiRenderer and build_renderer are march_bonsai.render_frame
    bitwise, one view and a batch of 3; the frame is within the exact
    contract of the JAX package's Pallas march in interpret mode (max 1e-3,
    mean 1e-5; test_torch_march_bonsai.py:69-74)."""
    (jmb,) = jax_interpreted("vokselis_tpu.ops.pallas.march_bonsai")
    vol = get_bonsai(32)
    ju = _jax_camera(aspect=W / H, **POSES["bench"]).uniform()
    u = _carried(ju)
    r = mb.BonsaiRenderer(vol, "cpu")
    img = r(u, W, H)
    assert torch.equal(img, mb.render_frame(r.vol, u, W, H))
    render, pack = mb.build_renderer(vol, "cpu")
    assert torch.equal(render(pack, u, W, H), img)
    batch = CameraUniform.stack([Camera(aspect=W / H, **p).uniform("cpu")
                                 for p in POSES.values()])
    assert torch.equal(r(batch, W, H, 200), mb.render_frame(r.vol, batch, W, H, 200))
    ref = np.asarray(jmb.BonsaiRenderer(vol)(ju, width=W, height=H))
    err = np.abs(img.numpy() - ref)
    assert err.max() < 1e-3 and err.mean() < 1e-5, (err.max(), err.mean())


def test_fast_entries_are_the_eager_frame_and_match_jax():
    """FastBonsaiRenderer and build_fast_renderer are _render_fast
    bitwise; the frame is within test_torch_fast.py:542-561's bounds of the
    JAX package's fast frame (XLA branch, max 2e-2, mean 3e-4)."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.shear_warp import FastBonsaiRenderer as JaxFast

    vol = get_bonsai(64)
    ju = _jax_camera(aspect=1.0, **POSES["bench"]).uniform()
    u = _carried(ju)
    r = shear_warp.FastBonsaiRenderer(vol, "cpu", intermediate=128)
    img = r(u, 64, 64)
    assert torch.equal(img, shear_warp._render_fast(r.packs, u, 64, 64, 128, True))
    render, pack = shear_warp.build_fast_renderer(vol, "cpu", intermediate=128)
    assert torch.equal(render(pack, u, 64, 64), img)
    ref = np.asarray(JaxFast(vol, intermediate=128)(ju, width=64, height=64))
    err = np.abs(img.numpy() - ref)
    assert err.max() <= 2e-2 and err.mean() <= 3e-4, (err.max(), err.mean())


def test_hybrid_route_is_the_eager_frame_and_matches_jax(jax_interpreted):
    """The hybrid route and the functional builders are _render_hybrid
    (with traced_degenerate's flag) bitwise; the frame is within
    test_torch_hybrid.py:563-596's bounds of the JAX package's
    HybridBonsaiRenderer on the CPU (max 2e-2, mean 3e-4)."""
    *_, jhy = jax_interpreted("vokselis_tpu.ops.pallas.march_bonsai",
                              "vokselis_tpu.ops.pallas.warp2d", "vokselis_tpu.ops.hybrid")
    vol = get_bonsai(64)
    ju = _jax_camera(aspect=1.0, **POSES["bench"]).uniform()
    u = _carried(ju)
    r = hy.HybridBonsaiRenderer(vol, "cpu", intermediate=128, budget=3)
    assert r.route(u, 96, 96) == ("hybrid", 128, 3)
    img = r(u, 96, 96)
    want = hy._render_hybrid(r.packs, r.vol, u, r.thresh, 96, 96, 128, 3, True)[0]
    assert torch.equal(img, want)
    frender, fpack = r.functional()
    fimg, ovf, deg = frender(fpack, u, 96, 96, budget=3)
    assert torch.equal(fimg, want) and ovf == 0
    assert torch.equal(deg, shear_warp.traced_degenerate(u, r.dims))
    render, pack = hy.build_hybrid_renderer(vol, "cpu", intermediate=128, budget=3)
    bimg, bdeg = render(pack, u, 96, 96)
    assert torch.equal(bimg, want) and not bool(bdeg)
    ref = np.asarray(jhy.HybridBonsaiRenderer(vol, intermediate=128, budget=3)(ju, 96, 96))
    err = np.abs(img.numpy() - ref)
    assert err.max() <= 2e-2 and err.mean() <= 3e-4, (err.max(), err.mean())


@pytest.mark.parametrize("route", ["escalated", "exact", "dense"])
def test_hybrid_other_routes_are_their_eager_frames(monkeypatch, route):
    """The escalated route (pose_hint degenerate at the base intermediate,
    not at 768) is _render_hybrid at I=768 with 1.5x the budget; the exact
    route (degenerate everywhere) and a dense volume's are the exact
    renderer's frame, march_bonsai.render_frame."""
    u = Camera(aspect=W / H, **POSES["bench"]).uniform("cpu")
    vol = dense_stress(32) if route == "dense" else get_bonsai(32)
    r = hy.HybridBonsaiRenderer(vol, "cpu", intermediate=64, budget=2)
    if route != "dense":
        degenerate = {"escalated": {64}, "exact": {64, 768, 1024}}[route]
        monkeypatch.setattr(hy, "pose_hint", lambda u, w, h, ii, d: (0, 128, ii in degenerate))
    mode, ii, budget = r.route(u, W, H)
    assert mode == route
    img = r(u, W, H)
    if route == "escalated":
        assert (ii, budget) == (768, 3)
        want = hy._render_hybrid(r.packs, r.vol, u, r.thresh, W, H, 768, 3, True,
                                 pair=hy._pair_mode(r.dims, W, H))[0]
    else:
        want = mb.render_frame(r.vol, u, W, H)
    assert torch.equal(img, want)


def test_field_entry_is_the_eager_frame_and_matches_jax(jax_interpreted):
    """FieldPipeline.render is march_field.render_field bitwise at two
    times, a float and a 0-d tensor, on one key; the frame is within
    test_torch_march_field.py:95-119's bounds of the JAX package's
    render_field_pallas in interpret mode (mean 1e-5, 99th percentile
    1e-3)."""
    (jmf,) = jax_interpreted("vokselis_tpu.ops.pallas.march_field")
    ju = _jax_camera_class().xor(W / H).uniform()
    u = _carried(ju)
    pipe = FieldPipeline("cpu", grad="analytic")
    frames = []
    for t in (0.0, torch.tensor(1.7)):
        frames.append(pipe.render(u, t, W, H))
        assert torch.equal(frames[-1], mf.render_field(u, t, W, H, grad="analytic"))
    assert pipe.compiled.captures == 2  # a float and a tensor time: two signatures
    pipe.render(u, 0.5, W, H)
    pipe.render(u, torch.tensor(0.5), W, H)
    assert pipe.compiled.captures == 2
    assert not torch.equal(frames[0], frames[1])
    ref = np.asarray(jmf.render_field_pallas(ju, 1.7, width=W, height=H, grad="analytic",
                                             tile_h=16, tile_w=128))
    d = np.abs(frames[1].numpy() - ref)
    assert d.mean() <= 1e-5 and np.quantile(d, 0.99) <= 1e-3, (d.mean(), np.quantile(d, 0.99))


def test_trig_entry_is_the_eager_frame_and_matches_jax():
    """TrigDemo's frame is trig_frame bitwise, and the JAX rasterizer's at
    >= 99.9 % of pixels (test_torch_demos.py:100-118)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.raster import rasterize_triangle as jax_raster

    ju = _jax_camera(zoom=1.2, pitch=0.3, yaw=2.5, aspect=W / H).uniform()
    ctx = Context(W, H, backbuffer_resolution=(W, H), device="cpu")
    ctx.camera_uniform = _carried(ju)
    demo = TrigDemo.init(ctx)
    ctx.update(time=1.25)
    demo.render(ctx)
    g = ctx.global_uniform
    img = ctx.render_backbuffer.texture
    assert torch.equal(img, trig_frame(ctx.camera_uniform.proj_view, g.time, g.mouse_pressed,
                                       W, H))
    tri = [jnp.asarray(v) for v in ((-0.5, -0.5, 0.0), (0.5, -0.5, 0.0), (0.0, 0.5, 0.0))]
    ref = np.asarray(jax_raster(ju.proj_view, *tri, jnp.asarray([0.25, 0.0, 1.0, 1.0]), W, H))
    assert (img.numpy() == ref).all(axis=-1).mean() >= 0.999
    assert (img.numpy()[..., 0] == 0.25).any()


@pytest.mark.parametrize("filt", list(FILTERS))
def test_present_entry_is_the_eager_pass_and_matches_jax(filt):
    """Presenter is present and to_uint8 bitwise, upscaled and at the same
    size; within test_torch_present.py's 1e-5 of the JAX package's."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.ops.present import present as jax_present

    hdr = (np.random.default_rng(11).random((H, W, 4)) * 3.0).astype(np.float32)
    p = Presenter()
    for oh, ow in ((2 * H, 2 * W), (H, W)):
        out = p(torch.from_numpy(hdr), oh, ow, filter=filt)
        assert torch.equal(out, present(torch.from_numpy(hdr), oh, ow, filter=filt))
        assert torch.equal(p.to_uint8(out), to_uint8(out))
        ref = np.asarray(jax_present(jnp.asarray(hdr), out_height=oh, out_width=ow,
                                     filter=filt))
        assert np.abs(out.numpy() - ref).max() < 1e-5
    assert p.compiled.captures == 4  # present and to_uint8, each at two sizes


def test_views_batch_step_is_the_eager_step():
    """ViewsBatch's batch step is its eager step bitwise, one key for every
    batch (t is an input)."""
    views = ViewsBatch(n_views=2, view_res=24, dims=32, device="cpu")
    for b in (0, 1):
        vol, imgs = views(b)
        want = views.step(torch.full((), 0.3 * b))
        assert torch.equal(vol, want[0]) and torch.equal(imgs, want[1])
    assert views.compiled.captures == 1


# -- the keys -----------------------------------------------------------------------------------

def test_a_new_uniform_reuses_the_key_and_static_arguments_make_new_ones():
    """A new uniform reuses each entry's key; a new width, intermediate,
    budget, srgb or batch size makes a new one (the JAX package's static
    arguments)."""
    us = [Camera(aspect=W / H, **p).uniform("cpu") for p in POSES.values()]
    exact = mb.BonsaiRenderer(get_bonsai(32), "cpu")
    for u in us:
        exact(u, W, H, 100)
    assert exact.compiled.captures == 1
    exact(us[0], W + 8, H, 100)
    exact(us[0], W, H, 100, srgb=False)
    exact(CameraUniform.stack(us), W, H, 100)
    exact(us[1], W, H, 100)
    assert exact.compiled.captures == 4
    fast = shear_warp.FastBonsaiRenderer(get_bonsai(32), "cpu", intermediate=64)
    for u in us:
        fast(u, W, H)
    fast(us[0], W, H, intermediate=128)
    fast(us[0], W, H, srgb=False)
    assert fast.compiled.captures == 3
    hybrid = hy.HybridBonsaiRenderer(get_bonsai(32), "cpu", intermediate=64, budget=2)
    for u in us:
        hybrid(u, W, H, route=("hybrid", 64, 2))
    hybrid(us[0], W, H, route=("hybrid", 64, 3))
    hybrid(us[0], W, H, route=("exact", None, None))
    assert hybrid.compiled.captures == 3
    assert {k[0][0] for k in hybrid.compiled.keys()} == {"hybrid", "exact"}


def test_reload_captures_again():
    """A reloaded field module drops the pipeline's keys: the next frame is
    traced again (the JAX package re-jits)."""
    from vokselis_torch.volume import fields_soa

    pipe = FieldPipeline("cpu", grad="analytic")
    u = Camera.xor(W / H).uniform("cpu")
    pipe.render(u, 0.0, W, H)
    pipe.render(u, 0.5, W, H)
    assert pipe.compiled.captures == 1
    pipe.reload(fields_soa)
    pipe.render(u, 0.0, W, H)
    assert pipe.compiled.captures == 2 and len(pipe.compiled.keys()) == 1


def test_compiled_frame_checks_its_inputs():
    """Inputs on two devices raise; off the card a call is the function's,
    numbers and tuples of outputs included."""
    frames = CompiledFrame("test")
    with pytest.raises(ValueError, match="test"):
        frames(("k",), lambda a, b: a, (torch.zeros(2), torch.zeros(2, device=META)))
    out = frames(("k",), lambda a, t: (a + t, a * t), (torch.ones(2), 2.0))
    assert [o.tolist() for o in out] == [[3.0, 3.0], [2.0, 2.0]]
    frames(("k",), lambda a, t: (a + t, a * t), (torch.ones(2), 3.0))
    assert frames.captures == 1


# -- on the card ----------------------------------------------------------------------------------

def _replays(cuda_device, entry):
    """(eager function of a pose, compiled call of a pose) of one entry at
    small sizes on the card; a pose is (uniform, time)."""
    vol = get_bonsai(64)
    if entry == "exact":
        r = mb.BonsaiRenderer(vol, cuda_device)
        return lambda u, t: mb.render_frame(r.vol, u, 96, 54), lambda u, t: r(u, 96, 54)
    if entry == "fast":
        r = shear_warp.FastBonsaiRenderer(vol, cuda_device, intermediate=64)
        return (lambda u, t: shear_warp._render_fast(r.packs, u, 96, 54, 64, True),
                lambda u, t: r(u, 96, 54))
    if entry == "hybrid":
        r = hy.HybridBonsaiRenderer(vol, cuda_device, intermediate=128, budget=4)
        route = ("hybrid", 128, 4)
        return (lambda u, t: hy._render_hybrid(r.packs, r.vol, u, r.thresh, 160, 90, 128, 4,
                                               True, pair=hy._pair_mode(64, 160, 90))[0],
                lambda u, t: r(u, 160, 90, route=route))
    if entry == "field":
        pipe = FieldPipeline(cuda_device, grad="analytic")
        return (lambda u, t: mf.render_field(u, t, 96, 54, grad="analytic"),
                lambda u, t: pipe.render(u, t, 96, 54))
    if entry == "present":
        p = Presenter()
        hdr = torch.rand((54, 96, 4), generator=torch.Generator().manual_seed(3)).to(cuda_device)
        return (lambda u, t: present(hdr * t, 108, 192, filter="bicubic"),
                lambda u, t: p(hdr * t, 108, 192, filter="bicubic"))
    views = ViewsBatch(n_views=2, view_res=32, dims=64, device=cuda_device)
    return (lambda u, t: views.step(torch.full((), 0.3 * round(t / 0.3),
                                               device=cuda_device))[1],
            lambda u, t: views(round(t / 0.3))[1])


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["exact", "fast", "hybrid", "field", "present", "views"])
def test_replays_are_the_eager_frames_on_gpu(cuda_device, entry):
    """Each entry's first call captures its graph; replays at three poses
    (the fast frame's m and sgn change between them) and times are bitwise
    the eager call on the same uniform and time, make no host sync, and
    keep earlier frames intact."""
    eager, compiled = _replays(cuda_device, entry)
    poses = [(Camera(aspect=16 / 9, **p).uniform(cuda_device), t)
             for p, t in zip(POSES.values(), (0.3, 0.6, 0.9))]
    first = compiled(*poses[0])
    kept = first.clone()
    for u, t in poses[1:] + poses[:1]:
        want = eager(u, t)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = compiled(u, t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
    assert torch.equal(first, kept)
    if entry == "fast":
        pk = shear_warp.prepare_fast_volume(get_bonsai(64), cuda_device)
        assert len({tuple(int(x) for x in (g.m[0], g.sgn[0])) for g in (
            shear_warp.fast_geometry(pk, u, 96, 54, 64) for u, _ in poses)}) == 3


@pytest.mark.gpu
def test_capture_failure_raises_on_gpu(cuda_device):
    """A frame that reads the device on the host cannot be captured: the
    call raises, naming the renderer and the key, and nothing is kept."""
    frames = CompiledFrame("syncing")

    def fn(x):
        return x * float(x.sum())

    with pytest.raises(RuntimeError, match="syncing.*'k'"):
        frames(("k",), fn, (torch.ones(4, device=cuda_device),))
    assert frames.keys() == []


@pytest.mark.gpu
def test_hybrid_routes_share_one_pool_on_gpu(cuda_device):
    """The hybrid renderer's routes replay graphs of one memory pool, and
    the exact route's frame is the exact renderer's."""
    r = hy.HybridBonsaiRenderer(get_bonsai(64), cuda_device, intermediate=128, budget=4)
    u = Camera.bonsai(16 / 9).uniform(cuda_device)
    img = r(u, 160, 90, route=("hybrid", 128, 4))
    ex = r(u, 160, 90, route=("exact", None, None))
    assert r.exact.compiled is r.compiled and r.compiled.pool is not None
    assert r.compiled.captures == 2 and img.shape == ex.shape
    assert torch.equal(ex, mb.render_frame(r.vol, u, 160, 90))
    assert torch.equal(r(u, 160, 90, route=("hybrid", 128, 4)), img)
