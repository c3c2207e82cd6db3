"""Multi-device rendering of the port (vokselis_torch.parallel.sharding) over
torch.distributed, against the JAX package's shard_map renderers.

The port runs in processes started by ``torch.multiprocessing.spawn``: a
gloo process group on the CPU, initialized through a ``file://`` store under
``tmp_path`` (parallel test workers never share a port), world 8 as a
(views=8, tiles=1) mesh and world 4 as (2, 2). The JAX side runs in this
process on conftest's 8-virtual-device CPU mesh, as tests/test_parallel.py
does. Both render the 16^3 bonsai with their plain marches on the same camera
uniforms (the cameras are host numpy code in both packages), held within
1e-5, the tolerance tests/test_parallel.py:30-64 allows between a sharded
and an unsharded render.

Each rank also runs the eager steps (``views_sharded_step``,
``frame_tiled_step``), which the cached entries (``render_views_sharded``,
``render_frame_tiled`` and ``multi_view_step`` with a stable renderer) must
return bitwise; off the card each entry records its key and runs the step.

The spawned children import this module to find :func:`_rank_main`; JAX is
imported only inside the tests, so the children never load it.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vokselis_torch.core.camera import Camera
from vokselis_torch.parallel import sharding
from vokselis_torch.volume.io import get_bonsai

TOL = 1e-5
SIZE, STEPS, VIEWS = 16, 8, 8


def _rank_main(rank, world, views, tiles, tmp):
    """One rank: init gloo through the file store, run every sharded
    renderer at this mesh, save what this rank holds."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank)
    try:
        mesh = sharding.make_mesh(views, tiles, device="cpu")
        dev = sharding.mesh_device(mesh)
        vol = get_bonsai(SIZE)
        render, pack = sharding.build_default_renderer(vol, dev)
        rays = sharding.build_ray_renderer(vol, dev, with_overflow=True)
        cams = sharding.orbit_camera_batch(VIEWS, device=dev)
        cam = Camera.bonsai(1.0).uniform(dev)
        out = {
            "local": sharding.render_views_sharded(mesh, render, pack, cams, SIZE, SIZE,
                                                   max_steps=STEPS),
            "gathered": sharding.render_views_sharded(mesh, render, pack, cams, SIZE, SIZE,
                                                      max_steps=STEPS, gather=True),
            "step": sharding.multi_view_step(mesh, vol, n_views=VIEWS, width=SIZE,
                                             height=SIZE, max_steps=4, gather=True),
            "tiled": sharding.render_frame_tiled(mesh, vol, Camera.bonsai(1.0).uniform(dev),
                                                 width=SIZE, height=SIZE, max_steps=STEPS,
                                                 with_overflow=True),
            "step_cached": sharding.multi_view_step(mesh, vol, n_views=VIEWS, width=SIZE,
                                                    height=SIZE, max_steps=4, gather=True,
                                                    renderer=(render, pack)),
            "tiled_cached": sharding.render_frame_tiled(mesh, None, cam, width=SIZE, height=SIZE,
                                                        max_steps=STEPS, renderer=rays,
                                                        with_overflow=True),
            "local_eager": sharding.views_sharded_step(mesh, render, pack, cams, SIZE, SIZE,
                                                       max_steps=STEPS),
            "gathered_eager": sharding.views_sharded_step(mesh, render, pack, cams, SIZE, SIZE,
                                                          max_steps=STEPS, gather=True),
            "step_eager": sharding.views_sharded_step(mesh, render, pack, cams, SIZE, SIZE,
                                                      max_steps=4, gather=True),
            "tiled_eager": sharding.frame_tiled_step(mesh, *rays, cam, SIZE, SIZE,
                                                     max_steps=STEPS, with_overflow=True),
            "keys": (len(sharding.VIEWS_STEPS.keys()), len(sharding.TILED_STEPS.keys())),
            "single": torch.stack([render(pack, c, SIZE, SIZE, STEPS) for c in cams]),
            "frame": render(pack, Camera.bonsai(1.0).uniform(dev), SIZE, SIZE, STEPS),
            "views_rank": mesh.get_local_rank("views"),
            "tiles_rank": mesh.get_local_rank("tiles"),
        }
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, views, tiles):
    world = views * tiles
    mp.spawn(_rank_main, args=(world, views, tiles, str(tmp_path)), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's sharded renders on its 8-device CPU mesh (tests/test_parallel.py)."""
    jax = pytest.importorskip("jax")
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    import jax.numpy as jnp

    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.parallel import sharding as jsh

    vol = jnp.asarray(get_bonsai(SIZE))
    render, pack = jsh.build_default_renderer(vol)
    cams = jsh.orbit_camera_batch(VIEWS)
    return {
        "views": np.asarray(jsh.render_views_sharded(jsh.make_mesh(views=8, tiles=1), render,
                                                     pack, cams, SIZE, SIZE, max_steps=STEPS,
                                                     gather=True)),
        "step": np.asarray(jsh.multi_view_step(jsh.make_mesh(views=4, tiles=2), vol,
                                               n_views=VIEWS, width=SIZE, height=SIZE,
                                               max_steps=4, gather=True)),
        "tiled": {tiles: np.asarray(jsh.render_frame_tiled(
            jsh.make_mesh(views=8 // tiles, tiles=tiles), vol, JaxCamera.bonsai(1.0).uniform(),
            width=SIZE, height=SIZE, max_steps=STEPS)) for tiles in (1, 2)},
    }


def _same_as_eager(out):
    """The cached entries return their eager steps bitwise: 3 views keys
    (local, gathered, the stable-renderer multi_view_step) and 1 tiled key
    (renderer=None records none)."""
    assert torch.equal(out["local"], out["local_eager"])
    assert torch.equal(out["gathered"], out["gathered_eager"])
    assert torch.equal(out["step_cached"], out["step_eager"])
    assert torch.equal(out["step"], out["step_eager"])
    for got, want in zip(out["tiled_cached"], out["tiled_eager"]):
        assert torch.equal(got, want)
    assert torch.equal(out["tiled"][0], out["tiled_eager"][0])
    assert out["keys"] == (3, 1)


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    err = np.abs(port - ref).max()
    assert err <= TOL, err


def test_world8_views_sharded_matches_jax(tmp_path, jax_frames):
    """(views=8, tiles=1): each rank holds its one view, equal to the
    unsharded render through the same pair; gathered, every rank holds all
    8 views, within 1e-5 of JAX's render_views_sharded; the frame sharded
    over tiles=1 is JAX's render_frame_tiled; every cached entry is its
    eager step bitwise."""
    outs = _spawn(tmp_path, views=8, tiles=1)
    for r, out in enumerate(outs):
        assert out["views_rank"] == r and out["tiles_rank"] == 0
        assert tuple(out["local"].shape) == (1, SIZE, SIZE, 4)
        assert torch.equal(out["local"][0], out["single"][r])
        assert torch.equal(out["gathered"], out["single"])
        _close(out["gathered"], jax_frames["views"])
        _close(out["step"], jax_frames["step"])
        img, ovf = out["tiled"]
        _close(img, jax_frames["tiled"][1])
        assert int(ovf) == 0
        _same_as_eager(out)


def test_world4_views_and_tiles_match_jax(tmp_path, jax_frames):
    """(views=2, tiles=2): ranks along 'tiles' render the same block of 4
    views; gathered views, multi_view_step and the row-sharded frame (two
    bands of 8 rows) match JAX's within 1e-5 on every rank; the overflow
    count is 0 (K1 has no window); the banded frame is bitwise the
    unsharded one; every cached entry is its eager step bitwise."""
    outs = _spawn(tmp_path, views=2, tiles=2)
    for r, out in enumerate(outs):
        vr, tr = divmod(r, 2)
        assert (out["views_rank"], out["tiles_rank"]) == (vr, tr)
        assert tuple(out["local"].shape) == (4, SIZE, SIZE, 4)
        assert torch.equal(out["local"], out["single"][4 * vr:4 * vr + 4])
        _close(out["gathered"], jax_frames["views"])
        _close(out["step"], jax_frames["step"])
        img, ovf = out["tiled"]
        _close(img, jax_frames["tiled"][2])
        assert int(ovf) == 0
        assert torch.equal(img, out["frame"])  # the bands are the whole frame's rows
        _same_as_eager(out)


def test_mesh_checks_world_size(tmp_path):
    """make_mesh needs an initialized group whose size is views x tiles
    (in this process: a gloo group of world 1 on a file store)."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        sharding.make_mesh(1, 1, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        with pytest.raises(ValueError, match="2x1 != 1"):
            sharding.make_mesh(2, 1, device="cpu")
        mesh = sharding.make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("views", "tiles") and mesh.shape == (1, 1)
        assert sharding.mesh_device(mesh) == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_on_the_default_backend_never_lands_on_the_cpu(tmp_path):
    """A group made with no backend named (what torchrun scripts often do)
    reports get_backend() == "undefined" and carries the backend of the
    machine's accelerator (NCCL where there is a card, gloo otherwise): the
    mesh takes the device its caller names, not a guess from that string,
    and a device the group has no backend for is refused. "cuda" gives a
    CUDA mesh on a machine with a card and is refused without one, never a
    CPU mesh."""
    dist.init_process_group(init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        assert dist.get_backend() != "nccl"
        if torch.cuda.is_available():
            mesh = sharding.make_mesh(1, 1, device="cuda")
            assert sharding.mesh_device(mesh).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                sharding.make_mesh(1, 1, device="cuda")
        if "cpu" in dist.get_backend_config():
            assert sharding.mesh_device(sharding.make_mesh(1, 1, device="cpu")).type == "cpu"
        else:
            with pytest.raises(RuntimeError, match="no backend for cpu"):
                sharding.make_mesh(1, 1, device="cpu")
        with pytest.raises(TypeError):
            sharding.make_mesh(1, 1)  # the device is required
    finally:
        dist.destroy_process_group()
