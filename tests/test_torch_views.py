"""Config 5's batch step (vokselis_torch.models.views.ViewsBatch) against the
JAX package: its K8 (generate_density_u8_pallas in interpret mode, as
tests/test_pallas.py runs it) followed by its oracle march
(vokselis_tpu.ops.reference.render_bonsai) over bench.py's orbit views, at
32^3 and 4 views of 64^2; and the dense-stress volume and frame, the other
volume bench.py renders (config 3 on volume.io.dense_stress).

On the CPU ViewsBatch runs K8's and K1's plain versions. The sharded batch
runs in processes started by ``torch.multiprocessing.spawn`` (a gloo group
through a ``file://`` store under ``tmp_path``, as tests/test_torch_parallel.py
does); JAX is imported only inside the tests, so the children never load it.
"""

import importlib
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vokselis_torch.core.camera import Camera
from vokselis_torch.models import views as views_model
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.parallel import sharding
from vokselis_torch.volume.io import dense_stress

DIMS, N_VIEWS, RES = 32, 4, 64
# the exact march's mean error against the JAX oracle on one volume (the
# exact path's contract, tests/test_torch_march_bonsai.py)
EXACT_MEAN = 1e-5
# the whole chain against JAX's: K8's plain version and the JAX kernel
# differ by a level or more on a few voxels (tests/test_torch_fields.py, the
# fbm hash's sine ulps), which moves a view's pixels through the transfer;
# held to the error budget of BASELINE.json
CHAIN_MEAN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the plain versions run many small torch ops, and
    an OpenMP team per op oversubscribes the CPU under the suite's parallel
    workers."""
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


def test_views_constants_match_bench():
    """bench_views_512's shape: 64 views at 512^2 of a 512^3 volume, the full
    diagonal of steps (888 at 512^3)."""
    assert (views_model.N_VIEWS, views_model.VIEW_RES, views_model.DIMS) == (64, 512, 512)
    assert views_model.full_diagonal(512) == 888
    assert views_model.full_diagonal(DIMS) == int(math.ceil(math.sqrt(3.0) * DIMS)) + 1


@pytest.mark.parametrize("b", [0, 1])
def test_views_batch_matches_jax(jax_genvol, b):
    """Batch step b: the volume against the JAX kernel's, held as
    tests/test_torch_fields.py holds the fbm hash (means and high quantiles,
    never the max: the sines differ by an ulp, which the hash amplifies):
    at least 99 % of voxels equal and the 99.9th percentile within one
    level; each view against JAX's oracle march of the port's own volume
    within the exact path's mean 1e-5, and against the whole JAX chain (its
    volume, its oracle) within CHAIN_MEAN."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai
    from vokselis_tpu.parallel.sharding import orbit_camera_batch as jax_orbit

    batch = views_model.ViewsBatch(N_VIEWS, RES, DIMS, device="cpu")
    vol, imgs = batch(b)
    assert vol.dtype == torch.uint8 and tuple(vol.shape) == (DIMS,) * 3
    assert tuple(imgs.shape) == (N_VIEWS, RES, RES, 4) and bool(torch.isfinite(imgs).all())
    t = np.float32(0.3) * np.float32(b)
    jvol = np.asarray(jax_genvol.generate_density_u8_pallas(t, DIMS, tile_z=8, tile_y=8))
    levels = np.abs(vol.numpy().astype(int) - jvol.astype(int))
    assert (levels == 0).mean() >= 0.99 and np.quantile(levels, 0.999) <= 1
    cams = jax_orbit(N_VIEWS)
    for i in range(N_VIEWS):
        u = batch.cams[i]
        ju = type(cams)(*(x[i] for x in (cams.view_position, cams.proj_view, cams.inv_proj)))
        np.testing.assert_array_equal(u.inv_proj.numpy(), np.asarray(ju.inv_proj))
        img = imgs[i].numpy()[..., :3]
        own = np.asarray(jax_render_bonsai(jnp.asarray(vol.numpy()), ju, RES, RES,
                                           max_steps=batch.max_steps))[..., :3]
        chain = np.asarray(jax_render_bonsai(jnp.asarray(jvol), ju, RES, RES,
                                             max_steps=batch.max_steps))[..., :3]
        assert np.abs(img - own).mean() <= EXACT_MEAN, i
        assert np.abs(img - chain).mean() <= CHAIN_MEAN, i
        assert (img.max(axis=-1) > 1.0 / 255.0).mean() > 0.01, i  # the cloud is in view


def test_views_batch_volume_changes_with_b():
    """Each batch step renders its own volume: t = 0 and t = 0.3 differ."""
    batch = views_model.ViewsBatch(2, 16, 16, device="cpu")
    (v0, f0), (v1, f1) = batch(0), batch(1)
    assert not torch.equal(v0, v1) and not torch.equal(f0, f1)


@pytest.mark.parametrize("n", [32])
def test_dense_stress_byte_identical_to_jax(n):
    """The dense-stress volume (bench.py:433-440, config 3's stress frame)
    is the JAX package's dense_stress() byte for byte, about half of its
    voxels above 0."""
    pytest.importorskip("jax")
    from vokselis_tpu.volume.io import dense_stress as jax_dense_stress

    port, ref = dense_stress(n), jax_dense_stress(n)
    assert port.dtype == ref.dtype == np.uint8 and port.shape == ref.shape == (n,) * 3
    assert port.tobytes() == ref.tobytes()
    assert 0.4 < (port > 0).mean() < 0.6


def test_dense_frame_matches_jax_oracle():
    """The dense frame through the exact entry point (BonsaiRenderer; its
    plain version on the CPU) at 32^3 and 64^2, bench pose, against the JAX
    package's oracle march over its own kernel path's rays
    (geometry.rays_fragment_soa, as its march kernel takes them): the exact
    path's mean 1e-5 over rgb. (Against render_bonsai, whose rays come from
    the AoS generator, both packages' SoA frames differ more on this fog:
    a direction one ulp off moves a deep ray's opacity exit.)"""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core import geometry as jax_geometry
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops.reference import render_bonsai_rays as jax_render_bonsai_rays

    vol = dense_stress(DIMS)
    img = BonsaiRenderer(vol, "cpu")(Camera.bonsai(1.0).uniform("cpu"), RES, RES)
    eye, dxyz = jax_geometry.rays_fragment_soa(JaxCamera.bonsai(1.0).uniform(), RES, RES)
    want = np.asarray(jax_render_bonsai_rays(jnp.asarray(vol), eye, jnp.stack(dxyz, axis=-1)))
    assert np.abs(img.numpy()[..., :3] - want[..., :3]).mean() <= EXACT_MEAN
    assert (img.numpy()[..., :3].max(axis=-1) > 1.0 / 255.0).mean() > 0.1


def _rank_views(rank, world, tmp):
    """One rank of a gloo group: the batch step sharded over the 'views'
    dimension, its block and every rank's blocks gathered, saved for the
    parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank)
    try:
        mesh = sharding.make_mesh(world, 1, device="cpu")
        local = views_model.ViewsBatch(N_VIEWS, RES, DIMS, mesh=mesh)(1)[1]
        blocks = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(blocks, local)
        gathered = torch.cat(blocks)
        torch.save({"local": local, "gathered": gathered}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_views_batch_sharded_matches_single(tmp_path):
    """With a (2, 1) mesh each rank renders its half of the views and the
    gathered batch is the single-device batch, bitwise (the same plain
    march on the same volume and uniforms)."""
    world = 2
    mp.spawn(_rank_views, args=(world, str(tmp_path)), nprocs=world, join=True)
    _, want = views_model.ViewsBatch(N_VIEWS, RES, DIMS, device="cpu")(1)
    per = N_VIEWS // world
    for rank in range(world):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert torch.equal(got["gathered"], want)
        assert torch.equal(got["local"], want[rank * per:(rank + 1) * per])
