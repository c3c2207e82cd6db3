"""The port's batched-view render against the JAX package's ``vmap``ped one.

The JAX package renders a batch of views as one program: a
``CameraUniform`` pytree with a leading (n_views,) axis
(``vokselis_tpu/parallel/sharding.py`` ``orbit_camera_batch``), whose ray
generation and march ``jax.vmap`` batches. The port carries the same axis:
a batched ``CameraUniform``, ``geometry.rays_fragment_soa`` over it, and
K1 with the view on its grid's z, so a batch is one ray pass and one
launch. On the CPU K1's wrapper takes its plain version, the plain march of
each view in turn. Every view of a batch is held bitwise to its own
single-view render; the port against JAX within the tolerances that
tests/test_torch_core.py (rays) and tests/test_parallel.py:30-45 (sharded
views, 1e-5) allow.

JAX is imported inside the tests only. Tests marked ``gpu`` skip without a
card.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.models import views as views_model
from vokselis_torch.ops import reference
from vokselis_torch.ops.cuda import genvol
from vokselis_torch.ops.cuda import march_bonsai as mb
from vokselis_torch.parallel import sharding
from vokselis_torch.volume.io import get_bonsai

FIELDS = ("view_position", "proj_view", "inv_proj")
ATOL = 1e-6  # tests/test_torch_core.py: a few float32 ulps
RAY_ILL_COND = 5e-4  # tests/test_torch_core.py: far-plane w cancellation
SHARD_TOL = 1e-5  # tests/test_parallel.py:30-45, sharded against unsharded


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the plain march runs many small torch ops, and
    an OpenMP team per op oversubscribes the CPU under the suite's parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _jax_batch(n, aspect=1.0):
    pytest.importorskip("jax")
    from vokselis_tpu.parallel.sharding import orbit_camera_batch as jax_orbit

    return jax_orbit(n, aspect=aspect)


class _Counter:
    """Wraps a module function and counts its calls."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)


def test_camera_uniform_batch_axis():
    """stack, len, an int index (one view, unbatched), a slice (a block of
    views, batched), iteration; an unbatched uniform keeps its shapes and
    has no len."""
    us = [Camera(yaw=0.4 * i, target=(0.5, 0.5, 0.5)).uniform("cpu") for i in range(5)]
    b = CameraUniform.stack(us)
    assert b.batched and not us[0].batched and len(b) == 5
    assert tuple(b.view_position.shape) == (5, 4)
    assert tuple(b.proj_view.shape) == tuple(b.inv_proj.shape) == (5, 4, 4)
    for i, u in enumerate(b):
        for name in FIELDS:
            assert torch.equal(getattr(u, name), getattr(us[i], name))
            assert torch.equal(getattr(b[i], name), getattr(us[i], name))
    block = b[1:4]
    assert block.batched and len(block) == 3
    assert torch.equal(block.inv_proj, b.inv_proj[1:4])
    assert tuple(us[0].view_position.shape) == (4,)
    with pytest.raises(TypeError):
        len(us[0])
    with pytest.raises(TypeError):
        us[0][0]
    with pytest.raises(ValueError):
        CameraUniform.stack([b])
    with pytest.raises(ValueError):
        CameraUniform.stack([])


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("aspect", [1.0, 1920 / 1080], ids=["square", "1080p"])
def test_orbit_camera_batch_bitwise_jax(n, aspect):
    """orbit_camera_batch is one batched uniform, bitwise the JAX package's
    stacked pytree; from_numpy carries JAX's stacked arrays across
    unchanged."""
    port = sharding.orbit_camera_batch(n, aspect=aspect, device="cpu")
    ref = _jax_batch(n, aspect)
    assert isinstance(port, CameraUniform) and len(port) == n
    carried = CameraUniform.from_numpy(*(np.asarray(getattr(ref, k)) for k in FIELDS), "cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
        assert torch.equal(getattr(carried, name), getattr(port, name))


@pytest.mark.parametrize("size", [(64, 36), (33, 17)], ids=["64x36", "33x17"])
def test_batched_rays_bitwise_per_view_and_match_jax_vmap(size):
    """rays_fragment_soa of a batched uniform: eye (V, 3) contiguous and
    planes (V, H, W), every view bitwise the single-view rays of its own
    uniform; against jax.vmap of the JAX package's rays_fragment_soa over
    the same (carried-across) uniforms within test_torch_core.py's
    tolerances."""
    import jax

    from vokselis_tpu.core import geometry as jgeom

    w, h = size
    n = 8
    ju = _jax_batch(n, w / h)
    u = CameraUniform.from_numpy(*(np.asarray(getattr(ju, k)) for k in FIELDS), "cpu")
    eye, dxyz = geometry.rays_fragment_soa(u, w, h)
    assert tuple(eye.shape) == (n, 3) and eye.is_contiguous()
    for d in dxyz:
        assert tuple(d.shape) == (n, h, w) and d.dtype == torch.float32
    for v in range(n):
        e1, d1 = geometry.rays_fragment_soa(u[v], w, h)
        assert torch.equal(eye[v], e1)
        for a, b in zip(dxyz, d1):
            assert torch.equal(a[v], b)
    jeye, jdxyz = jax.vmap(lambda c: jgeom.rays_fragment_soa(c, w, h))(ju)
    np.testing.assert_allclose(eye.numpy(), np.asarray(jeye), rtol=0, atol=ATOL)
    for a, b in zip(dxyz, jdxyz):
        err = np.abs(a.numpy() - np.asarray(b))
        assert (err <= ATOL).mean() >= 0.99, (err <= ATOL).mean()
        assert err.max() <= RAY_ILL_COND, err.max()


def test_mat4_apply_batched_broadcasts_per_view():
    """A (V, 4, 4) matrix applies each view's own entries, (V, 1, 1)
    against (H, W) planes, bitwise the (4, 4) product of each view."""
    rng = np.random.default_rng(11)
    m = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    x, y = (torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)) for _ in range(2))
    out = geometry.mat4_apply(m, x, y, 0.25)
    for v in range(3):
        for a, b in zip(out, geometry.mat4_apply(m[v], x, y, 0.25)):
            assert tuple(a.shape) == (3, 5, 7) and torch.equal(a[v], b)


def test_batched_plain_k1_equals_per_view():
    """K1's wrapper on CPU tensors, batched (one call), is bitwise the plain
    march of each view on its own, as is render_bonsai_rays_plain; it
    launches nothing; malformed batches are refused (a strided eye, planes
    whose views do not match the eyes')."""
    vol = mb.volume_tensor(get_bonsai(32), "cpu")
    u = sharding.orbit_camera_batch(4, aspect=24 / 16, device="cpu")
    eye, dxyz = geometry.rays_fragment_soa(u, 24, 16)
    before = mb.LAUNCHES
    img = mb.render_bonsai_rays_cuda(vol, eye, dxyz, max_steps=80)
    assert mb.LAUNCHES == before and tuple(img.shape) == (4, 16, 24, 4)
    assert torch.equal(img, mb.render_bonsai_rays_plain(vol, eye, dxyz, max_steps=80))
    for v in range(4):
        one = reference.render_bonsai_rays(vol, eye[v], torch.stack([d[v] for d in dxyz], -1),
                                           max_steps=80)
        assert torch.equal(img[v], one), v
    assert (img[..., :3].amax(dim=-1) > 1.0 / 255.0).float().mean() > 0.01
    with pytest.raises(ValueError, match="contiguous"):
        mb.render_bonsai_rays_cuda(vol, u.view_position[..., :3], dxyz)
    with pytest.raises(ValueError, match="like dx"):
        mb.render_bonsai_rays_cuda(vol, eye[:3], dxyz)
    with pytest.raises(ValueError, match="like dx"):
        mb.render_bonsai_rays_cuda(vol, eye[0], dxyz)


def test_renderer_renders_a_batch_in_one_call(monkeypatch):
    """build_renderer's render over a batched uniform: one ray pass, one
    call of K1's plain version, (V, H, W, 4) bitwise the views rendered one
    by one; the BonsaiRenderer entry point gives the same batch."""
    render, pack = mb.build_renderer(get_bonsai(32), "cpu")
    u = sharding.orbit_camera_batch(3, device="cpu")
    singles = torch.stack([render(pack, c, 20, 20, 60) for c in u])
    rays = _Counter(monkeypatch, geometry, "rays_fragment_soa")
    k1 = _Counter(monkeypatch, mb, "render_bonsai_rays_plain")
    img = render(pack, u, 20, 20, 60)
    assert (rays.calls, k1.calls) == (1, 1)
    assert torch.equal(img, singles)
    assert torch.equal(mb.BonsaiRenderer(get_bonsai(32), "cpu")(u, 20, 20, 60), singles)


def test_views_batch_bitwise_per_view_loop(monkeypatch):
    """ViewsBatch's step (K8's and K1's plain versions here) is bitwise the
    per-view loop it replaced (the same volume, then each view rendered on
    its own), with one ray pass and one call of K1's plain version for the
    batch."""
    batch = views_model.ViewsBatch(4, 24, 16, device="cpu")
    rays = _Counter(monkeypatch, geometry, "rays_fragment_soa")
    k1 = _Counter(monkeypatch, mb, "render_bonsai_rays_plain")
    vol, imgs = batch(1)
    assert (rays.calls, k1.calls) == (1, 1)
    want_vol = genvol.generate_density_u8(0.3 * 1, 16, "cpu")
    render, pack = sharding.build_default_renderer(want_vol, "cpu")
    want = torch.stack([render(pack, c, 24, 24, batch.max_steps) for c in batch.cams])
    assert torch.equal(vol, want_vol) and torch.equal(imgs, want)
    assert tuple(imgs.shape) == (4, 24, 24, 4)


def test_render_views_sharded_matches_jax_mesh(tmp_path, monkeypatch):
    """render_views_sharded and multi_view_step on a gloo world of one (this
    process) render their block, all 8 views, with one render call (one ray
    pass); against JAX's render_views_sharded on its 8-device CPU mesh at
    tests/test_parallel.py:30-45's shape (get_bonsai(16), 8 views, 16x16,
    max_steps 8) within 1e-5, and bitwise the views rendered one by one."""
    jax = pytest.importorskip("jax")
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    import jax.numpy as jnp

    from vokselis_tpu.parallel import sharding as jsh

    vol = get_bonsai(16)
    jrender, jpack = jsh.build_default_renderer(jnp.asarray(vol))
    want = np.asarray(jsh.render_views_sharded(jsh.make_mesh(views=8, tiles=1), jrender, jpack,
                                               jsh.orbit_camera_batch(8), 16, 16, max_steps=8,
                                               gather=True))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = sharding.make_mesh(1, 1, device="cpu")
        render, pack = sharding.build_default_renderer(vol, "cpu")
        cams = sharding.orbit_camera_batch(8, device="cpu")
        singles = torch.stack([render(pack, c, 16, 16, 8) for c in cams])
        rays = _Counter(monkeypatch, geometry, "rays_fragment_soa")
        got = sharding.render_views_sharded(mesh, render, pack, cams, 16, 16, max_steps=8,
                                            gather=True)
        assert rays.calls == 1
        step = sharding.multi_view_step(mesh, vol, n_views=8, width=16, height=16, max_steps=8,
                                        gather=True)
        assert rays.calls == 2
    finally:
        dist.destroy_process_group()
    assert tuple(got.shape) == want.shape == (8, 16, 16, 4)
    assert torch.equal(got, singles) and torch.equal(step, got)
    assert np.abs(got.numpy() - want).max() <= SHARD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(96, 64), (101, 57)], ids=["96x64", "101x57"])
def test_batched_kernel_matches_single_launches_on_gpu(cuda_device, size):
    """On the card a batch is one K1 launch, each view bitwise a single-view
    launch on its uniform and the plain version (partial 16x8 blocks on
    both axes at 101x57)."""
    w, h = size
    vol = mb.volume_tensor(get_bonsai(64), cuda_device)
    u = sharding.orbit_camera_batch(5, aspect=w / h, device=cuda_device)
    eye, dxyz = geometry.rays_fragment_soa(u, w, h)
    before = mb.LAUNCHES
    img = mb.render_bonsai_rays_cuda(vol, eye, dxyz)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == before + 1 and tuple(img.shape) == (5, h, w, 4)
    plain = mb.render_bonsai_rays_plain(vol, eye, dxyz)
    for v in range(5):
        e1, d1 = geometry.rays_fragment_soa(u[v], w, h)
        assert torch.equal(img[v], mb.render_bonsai_rays_cuda(vol, e1, d1)), v
    assert torch.equal(img, plain)
