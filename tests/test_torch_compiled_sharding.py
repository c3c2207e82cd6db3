"""The port's compiled sharded steps (vokselis_torch.parallel.sharding: the
counterparts of the JAX package's ``_views_sharded_fn`` and
``_frame_tiled_fn``, jitted shard_maps under ``functools.lru_cache(maxsize=64)``).

In this process a gloo group of world 1 on a file store, as
test_torch_parallel.py::test_mesh_checks_world_size makes one. Off the card
each entry runs its eager step and records its key, so these tests hold the
keys (static arguments, the batch's size, the mesh's process groups, never
the mesh; a fresh default renderer records none; at most 64 keys, the least
recently used evicted; a destroyed group's keys dropped) and every entry
bitwise against its eager step (``views_sharded_step``,
``frame_tiled_step``, ``ViewsBatch.step``), and the entries against the JAX
package's jitted steps on a one-device mesh within 1e-5
(tests/test_parallel.py's tolerance).

Tests marked ``gpu`` need a CUDA card and skip without one: on an NCCL group
of world 1 each entry's replays at three poses or batches are bitwise its
eager step, with one capture per key and no host sync, and a new group
captures again; on a machine with two or more cards, an NCCL world of one
process a card replays the gathered views and the row-sharded frame
bitwise their eager steps on every rank (skipped on one card). On the
card run ``python -m pytest tests/test_torch_compiled_sharding.py
--noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.engine.compiled import CompiledFrame
from vokselis_torch.models.views import ViewsBatch
from vokselis_torch.parallel import sharding
from vokselis_torch.volume.io import get_bonsai

SIZE, STEPS, VIEWS = 16, 8, 4
TOL = 1e-5  # tests/test_parallel.py:30-64
POSES = [dict(zoom=1.0, pitch=0.5, yaw=1.0), dict(zoom=1.0, pitch=0.5, yaw=3.0),
         dict(zoom=1.0, pitch=1.2, yaw=0.3)]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh():
    """Empty caches of the sharded steps, their capture counts at 0."""
    sharding.clear_steps()
    sharding.VIEWS_STEPS.captures = sharding.TILED_STEPS.captures = 0


def _world(tmp_path, backend, name="store"):
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/{name}", world_size=1,
                            rank=0)


@pytest.fixture
def cpu_mesh(tmp_path):
    """A (1, 1) mesh on the CPU over a gloo group of world 1, and empty
    caches of the sharded steps."""
    _fresh()
    _world(tmp_path, "gloo")
    try:
        yield sharding.make_mesh(1, 1, device="cpu")
    finally:
        sharding.clear_steps()
        if dist.is_initialized():
            dist.destroy_process_group()


def _pairs(device="cpu"):
    vol = get_bonsai(SIZE)
    return (vol, sharding.build_default_renderer(vol, device),
            sharding.build_ray_renderer(vol, device, with_overflow=True))


def _cams(n, device="cpu", yaw0=0.0):
    return CameraUniform.stack(Camera(zoom=1.0, pitch=0.5, yaw=yaw0 + 0.7 * i,
                                      target=(0.5, 0.5, 0.5), aspect=1.0).uniform(device)
                               for i in range(n))


def _pose(i, device="cpu"):
    return Camera(target=(0.5, 0.5, 0.5), aspect=1.0, **POSES[i]).uniform(device)


def _cams_orbit(n):
    return sharding.orbit_camera_batch(n, device="cpu")


# -- the keys -------------------------------------------------------------------------------------

def test_views_key_is_the_static_arguments_and_the_batch_size(cpu_mesh):
    """A new uniform of the same size reuses the key; a new width,
    max_steps, gather or batch size records another, as each static
    argument of the JAX package's _views_sharded_fn does."""
    _, (render, pack), _ = _pairs()
    steps = sharding.VIEWS_STEPS
    for yaw0 in (0.0, 0.4, 1.1):
        sharding.render_views_sharded(cpu_mesh, render, pack, _cams(VIEWS, yaw0=yaw0), SIZE,
                                      SIZE, max_steps=STEPS)
    assert steps.captures == 1
    sharding.render_views_sharded(cpu_mesh, render, pack, _cams(VIEWS), SIZE + 8, SIZE,
                                  max_steps=STEPS)
    sharding.render_views_sharded(cpu_mesh, render, pack, _cams(VIEWS), SIZE, SIZE,
                                  max_steps=STEPS + 1)
    sharding.render_views_sharded(cpu_mesh, render, pack, _cams(VIEWS), SIZE, SIZE,
                                  max_steps=STEPS, gather=True)
    sharding.render_views_sharded(cpu_mesh, render, pack, _cams(VIEWS + 2), SIZE, SIZE,
                                  max_steps=STEPS)
    assert steps.captures == 5 and len(steps.keys()) == 5
    groups = sharding.mesh_groups(cpu_mesh)
    assert all(key[0][0] == groups and key[0][1] is render for key in steps.keys())


def test_tiled_key_and_a_fresh_renderer_records_none(cpu_mesh):
    """render_frame_tiled with a stable pair: one key for every pose, another
    for with_overflow or a new size; with renderer=None the pair is built
    for the call and nothing is recorded, in render_frame_tiled and in
    multi_view_step (JAX: the fresh closure caches nothing)."""
    vol, (render, pack), rays = _pairs()
    for i in range(3):
        sharding.render_frame_tiled(cpu_mesh, None, _pose(i), SIZE, SIZE, max_steps=STEPS,
                                    renderer=rays)
    assert sharding.TILED_STEPS.captures == 1
    sharding.render_frame_tiled(cpu_mesh, None, _pose(0), SIZE, SIZE, max_steps=STEPS,
                                renderer=rays, with_overflow=True)
    sharding.render_frame_tiled(cpu_mesh, None, _pose(0), SIZE, SIZE // 2, max_steps=STEPS,
                                renderer=rays)
    assert sharding.TILED_STEPS.captures == 3
    sharding.render_frame_tiled(cpu_mesh, vol, _pose(1), SIZE, SIZE, max_steps=STEPS)
    sharding.multi_view_step(cpu_mesh, vol, VIEWS, SIZE, SIZE, max_steps=STEPS)
    assert sharding.TILED_STEPS.captures == 3 and sharding.VIEWS_STEPS.captures == 0
    sharding.multi_view_step(cpu_mesh, vol, VIEWS, SIZE, SIZE, max_steps=STEPS,
                             renderer=(render, pack))
    sharding.multi_view_step(cpu_mesh, vol, VIEWS, SIZE, SIZE, max_steps=STEPS,
                             renderer=(render, pack))
    assert sharding.VIEWS_STEPS.captures == 1


def test_cache_holds_at_most_64_keys_least_recently_used_first(cpu_mesh):
    """70 keys (max_steps 1..70) through a cache of 64: it never holds more
    than 64; the least recently used key goes first, so a key called again
    stays; an evicted key records anew."""
    _, (render, pack), _ = _pairs()
    steps = sharding.VIEWS_STEPS
    cams = _cams(1)

    def call(n):
        sharding.render_views_sharded(cpu_mesh, render, pack, cams, 4, 4, max_steps=n)

    held = []
    for n in range(1, 71):
        call(n)
        if n == 64:
            call(1)  # 1 is now the most recent, 2 the least
        held.append(len(steps.keys()))
    assert max(held) == sharding.MAX_KEYS == 64 and held[63:] == [64] * 7
    kept = {key[0][4] for key in steps.keys()}
    assert kept == {1} | set(range(8, 71))
    call(2)
    assert steps.captures == 71 and 2 in {key[0][4] for key in steps.keys()}


def test_compiled_frame_evicts_the_least_recently_used_key():
    """CompiledFrame(maxsize=3) off the card: a hit refreshes a key, a fourth
    key evicts the oldest; without maxsize nothing is evicted."""
    frames = CompiledFrame("lru", maxsize=3)
    x = torch.ones(2)
    for k in ("a", "b", "c", "a", "d"):
        frames((k,), lambda t: t + 1, (x,))
    assert [key[0] for key in frames.keys()] == [("c",), ("a",), ("d",)]
    assert frames.captures == 4
    frames.drop(lambda key: key == ("a",))
    assert [key[0] for key in frames.keys()] == [("c",), ("d",)]
    unbounded = CompiledFrame("all")
    for k in range(80):
        unbounded((k,), lambda t: t, (x,))
    assert len(unbounded.keys()) == 80


def test_a_destroyed_group_never_matches(tmp_path):
    """After destroy_process_group and a new group of the same layout, the new
    mesh compares equal to the old one, but a call records a fresh key on
    the new groups and the old group's keys are dropped: in both sharded
    caches and in a ViewsBatch made on the old mesh (whose groups now
    resolve to the new ones)."""
    _, (render, pack), rays = _pairs()
    _fresh()
    _world(tmp_path, "gloo", "first")
    try:
        old = sharding.make_mesh(1, 1, device="cpu")
        old_groups = sharding.mesh_groups(old)
        batch = ViewsBatch(n_views=2, view_res=SIZE, dims=32, mesh=old)
        batch(0)
        sharding.render_views_sharded(old, render, pack, _cams(VIEWS), SIZE, SIZE, STEPS)
        sharding.render_frame_tiled(old, None, _pose(0), SIZE, SIZE, STEPS, renderer=rays)
    finally:
        dist.destroy_process_group()
    _world(tmp_path, "gloo", "second")
    try:
        new = sharding.make_mesh(1, 1, device="cpu")
        groups = sharding.mesh_groups(new)
        assert new == old and groups != old_groups
        views = sharding.render_views_sharded(new, render, pack, _cams(VIEWS), SIZE, SIZE,
                                              STEPS)
        frame = sharding.render_frame_tiled(new, None, _pose(0), SIZE, SIZE, STEPS,
                                            renderer=rays)
        vol, imgs = batch(0)
        for steps in (sharding.VIEWS_STEPS, sharding.TILED_STEPS, batch.compiled):
            assert steps.captures == 2
            assert [key[0][0] if steps is not batch.compiled else key[0][-1]
                    for key in steps.keys()] == [groups]
        assert torch.equal(views, sharding.views_sharded_step(new, render, pack, _cams(VIEWS),
                                                              SIZE, SIZE, STEPS))
        assert torch.equal(frame, sharding.frame_tiled_step(new, *rays, _pose(0), SIZE, SIZE,
                                                            STEPS))
        assert torch.equal(imgs, batch.step(torch.full((), 0.0))[1])
    finally:
        sharding.clear_steps()
        dist.destroy_process_group()


# -- each entry against its eager step ------------------------------------------------------------

@pytest.mark.parametrize("entry", ["views", "views gathered", "tiled", "tiled overflow",
                                   "multi_view_step"])
def test_entries_are_their_eager_steps(cpu_mesh, entry):
    """Each entry's output at three poses (or view batches) is bitwise its
    eager step on the same inputs, and one key serves them all."""
    vol, (render, pack), rays = _pairs()
    for i in range(3):
        if entry.startswith("views"):
            gather = entry.endswith("gathered")
            cams = _cams(VIEWS, yaw0=0.5 * i)
            got = sharding.render_views_sharded(cpu_mesh, render, pack, cams, SIZE, SIZE,
                                                STEPS, gather=gather)
            want = sharding.views_sharded_step(cpu_mesh, render, pack, cams, SIZE, SIZE,
                                               STEPS, gather=gather)
        elif entry.startswith("tiled"):
            ovf = entry.endswith("overflow")
            got = sharding.render_frame_tiled(cpu_mesh, None, _pose(i), SIZE, SIZE, STEPS,
                                              renderer=rays, with_overflow=ovf)
            want = sharding.frame_tiled_step(cpu_mesh, *rays, _pose(i), SIZE, SIZE, STEPS,
                                             with_overflow=ovf)
        else:
            got = sharding.multi_view_step(cpu_mesh, vol, VIEWS, SIZE, SIZE, max_steps=STEPS + i,
                                           renderer=(render, pack))
            want = sharding.views_sharded_step(cpu_mesh, render, pack, _cams_orbit(VIEWS), SIZE,
                                               SIZE, STEPS + i, gather=True)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    steps = sharding.TILED_STEPS if entry.startswith("tiled") else sharding.VIEWS_STEPS
    assert steps.captures == (3 if entry == "multi_view_step" else 1)


def test_views_batch_with_a_mesh_is_its_eager_step(cpu_mesh):
    """ViewsBatch(mesh=...) goes through its compiled step too: batches 0-2
    bitwise ViewsBatch.step, one key holding the mesh's groups."""
    views = ViewsBatch(n_views=2, view_res=SIZE, dims=32, mesh=cpu_mesh)
    for b in range(3):
        vol, imgs = views(b)
        want = views.step(torch.full((), 0.3 * b))
        assert torch.equal(vol, want[0]) and torch.equal(imgs, want[1])
    assert views.compiled.captures == 1
    assert views.compiled.keys()[0][0][-1] == sharding.mesh_groups(cpu_mesh)
    assert sharding.VIEWS_STEPS.captures == 0  # the step calls views_sharded_step itself


def test_entries_match_jax_jitted_steps(cpu_mesh):
    """The cached entries at world 1 against the JAX package's jitted
    shard_map steps on a one-device mesh (the jnp oracle), within 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.parallel import sharding as jsh

    jmesh = jsh.make_mesh(1, 1, devices=jax.devices()[:1])
    vol, (render, pack), rays = _pairs()
    jvol = jnp.asarray(vol)
    jrender, jpack = jsh.build_default_renderer(jvol)
    want_views = np.asarray(jsh.render_views_sharded(jmesh, jrender, jpack,
                                                     jsh.orbit_camera_batch(VIEWS), SIZE, SIZE,
                                                     max_steps=STEPS, gather=True))
    got_views = sharding.render_views_sharded(cpu_mesh, render, pack, _cams_orbit(VIEWS), SIZE,
                                              SIZE, max_steps=STEPS, gather=True)
    want_frame = np.asarray(jsh.render_frame_tiled(jmesh, jvol, JaxCamera.bonsai(1.0).uniform(),
                                                   SIZE, SIZE, max_steps=STEPS))
    got_frame = sharding.render_frame_tiled(cpu_mesh, None, Camera.bonsai(1.0).uniform("cpu"),
                                            SIZE, SIZE, max_steps=STEPS, renderer=rays)
    for got, want in ((got_views, want_views), (got_frame, want_frame)):
        assert got.shape == want.shape and np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - want).max() <= TOL


# -- on the card ----------------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(tmp_path):
    """A (1, 1) mesh on card 0 over an NCCL group of world 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _fresh()
    _world(tmp_path, "nccl")
    try:
        yield sharding.make_mesh(1, 1, device=dev)
    finally:
        sharding.clear_steps()
        if dist.is_initialized():
            dist.destroy_process_group()


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["views", "views gathered", "tiled overflow",
                                   "multi_view_step", "ViewsBatch"])
def test_replays_are_the_eager_steps_on_gpu(nccl_mesh, entry):
    """The first call captures the step (its collectives inside); replays at
    three poses or batches are bitwise the eager step, make no host sync,
    and leave earlier results intact; one capture per key."""
    dev = sharding.mesh_device(nccl_mesh)
    vol, (render, pack), rays = _pairs(dev)
    if entry == "ViewsBatch":
        views = ViewsBatch(n_views=4, view_res=32, dims=64, mesh=nccl_mesh)
        compiled = views.compiled

        def call(i):
            return views(i)[1]

        def eager(i):
            return views.step(torch.full((), 0.3 * i, device=dev))[1]
    elif entry.startswith("views") or entry == "multi_view_step":
        gather = entry != "views"
        compiled = sharding.VIEWS_STEPS
        batches = [_cams(VIEWS, dev, yaw0=0.5 * i) for i in range(3)]
        if entry == "multi_view_step":
            batches = [sharding.orbit_camera_batch(VIEWS, device=dev)] * 3

        def call(i):
            if entry == "multi_view_step":
                return sharding.multi_view_step(nccl_mesh, vol, VIEWS, 48, 32, max_steps=64,
                                                renderer=(render, pack))
            return sharding.render_views_sharded(nccl_mesh, render, pack, batches[i], 48, 32,
                                                 64, gather=gather)

        def eager(i):
            return sharding.views_sharded_step(nccl_mesh, render, pack, batches[i], 48, 32, 64,
                                               gather=gather)
    else:
        compiled = sharding.TILED_STEPS

        def call(i):
            return sharding.render_frame_tiled(nccl_mesh, None, _pose(i, dev), 48, 32, 64,
                                               renderer=rays, with_overflow=True)

        def eager(i):
            return sharding.frame_tiled_step(nccl_mesh, *rays, _pose(i, dev), 48, 32, 64,
                                             with_overflow=True)
    first = call(0)
    kept = tuple(t.clone() for t in first) if isinstance(first, tuple) else first.clone()
    for i in (1, 2, 0):
        want = eager(i)
        got = _no_sync(lambda: call(i))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    for g, k in zip(first if isinstance(first, tuple) else (first,),
                    kept if isinstance(kept, tuple) else (kept,)):
        assert torch.equal(g, k)
    assert compiled.captures == 1


@pytest.mark.gpu
def test_a_new_group_captures_again_on_gpu(nccl_mesh, tmp_path):
    """After the group is destroyed and a new one made, each entry captures
    again on the new group and replays it bitwise its eager step."""
    dev = sharding.mesh_device(nccl_mesh)
    _, (render, pack), rays = _pairs(dev)
    cams = _cams(VIEWS, dev)
    sharding.render_views_sharded(nccl_mesh, render, pack, cams, 48, 32, 64, gather=True)
    sharding.render_frame_tiled(nccl_mesh, None, _pose(0, dev), 48, 32, 64, renderer=rays)
    dist.destroy_process_group()
    _world(tmp_path, "nccl", "again")
    mesh = sharding.make_mesh(1, 1, device=dev)
    assert mesh == nccl_mesh
    for _ in range(2):
        views = sharding.render_views_sharded(mesh, render, pack, cams, 48, 32, 64, gather=True)
        frame = sharding.render_frame_tiled(mesh, None, _pose(0, dev), 48, 32, 64,
                                            renderer=rays)
    assert sharding.VIEWS_STEPS.captures == sharding.TILED_STEPS.captures == 2
    assert len(sharding.VIEWS_STEPS.keys()) == len(sharding.TILED_STEPS.keys()) == 1
    assert torch.equal(views, sharding.views_sharded_step(mesh, render, pack, cams, 48, 32, 64,
                                                          gather=True))
    assert torch.equal(frame, sharding.frame_tiled_step(mesh, *rays, _pose(0, dev), 48, 32, 64))


def _card_rank_main(rank, world, tmp):
    """One rank of an NCCL world over ``world`` cards: each entry's replays
    at three inputs against its eager step (bitwise, host syncs refused),
    captures per key; saves what it found."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank)
    found = {}
    try:
        _, (render, pack), rays = _pairs(dev)
        views_mesh = sharding.make_mesh(world, 1, device=dev)
        tiles_mesh = sharding.make_mesh(1, world, device=dev)
        batches = [_cams(2 * world, dev, yaw0=0.5 * i) for i in range(3)]
        for name, call, eager in (
                ("views", lambda i: sharding.render_views_sharded(
                    views_mesh, render, pack, batches[i], 48, 32, 64, gather=True),
                 lambda i: sharding.views_sharded_step(views_mesh, render, pack, batches[i], 48,
                                                       32, 64, gather=True)),
                ("tiled", lambda i: sharding.render_frame_tiled(
                    tiles_mesh, None, _pose(i, dev), 48, 32, 64, renderer=rays,
                    with_overflow=True),
                 lambda i: sharding.frame_tiled_step(tiles_mesh, *rays, _pose(i, dev), 48, 32,
                                                     64, with_overflow=True))):
            call(0)
            equal = 0
            for i in (1, 2, 0):
                want = eager(i)
                got = _no_sync(lambda: call(i))
                equal += all(torch.equal(g, w) for g, w in
                             zip(got if isinstance(got, tuple) else (got,),
                                 want if isinstance(want, tuple) else (want,)))
            found[name] = equal
        found["captures"] = (sharding.VIEWS_STEPS.captures, sharding.TILED_STEPS.captures)
    finally:
        sharding.clear_steps()  # NCCL keeps a communicator while a graph holds its collectives
        dist.destroy_process_group()
    torch.save(found, f"{tmp}/rank{rank}.pt")


@pytest.mark.gpu
def test_replays_across_cards_on_gpu(tmp_path):
    """On a machine with several cards, an NCCL world of one process a card:
    on every rank the gathered views and the row-sharded frame replay their
    graphs (NCCL's collectives inside) bitwise their eager steps at three
    inputs, without a host sync, one capture each."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    mp.spawn(_card_rank_main, args=(world, str(tmp_path)), nprocs=world, join=True)
    for r in range(world):
        found = torch.load(tmp_path / f"rank{r}.pt")
        assert found == {"views": 3, "tiled": 3, "captures": (1, 1)}, (r, found)
