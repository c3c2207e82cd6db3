"""Multi-device rendering over ``torch.distributed``: batched multi-view and
row-sharded single frames.

The port of ``vokselis_tpu/parallel/sharding.py``. The JAX package runs one
program over a ``("views", "tiles")`` device mesh with ``shard_map``; here
each device is a process of an initialized process group (NCCL on CUDA
cards, gloo on the CPU) and :func:`make_mesh` lays a
``torch.distributed.device_mesh.DeviceMesh`` of the device its caller names,
with the same two dimension names, over its ranks:

- BASELINE.json config 5 (batched 64-view rendering) -> data parallelism
  over 'views': each rank renders its contiguous block of a batched camera
  uniform with one call of the unchanged single-device renderer, one ray
  pass and one K1 launch for the block (the JAX package's ``vmap`` under
  ``P("views")``); ``gather=True`` all-gathers the frames over the 'views'
  group, so every rank holds all;
- image-space tile sharding -> each 'tiles' rank marches its band of frame
  ROWS (rays are independent: no halo exchange); an all-gather over the
  'tiles' group assembles the frame.

Each path is one step, a module function that runs eagerly
(:func:`views_sharded_step`, :func:`frame_tiled_step`: the JAX package's
``local_step``s), and one entry that replays it, as the JAX package's
``jax.jit(shard_map(local_step))`` under ``functools.lru_cache(maxsize=64)``
does: :func:`render_views_sharded` and :func:`render_frame_tiled` go through
a :class:`~vokselis_torch.core.compiled.CompiledFrame` of at most 64 keys
(:data:`VIEWS_STEPS`, :data:`TILED_STEPS`). On a card the first call with
a key captures the step, its NCCL collectives inside, into one CUDA graph
and later calls replay it; off the card (gloo on the CPU) every call runs
the step and records its key. A key holds the mesh's process groups (never
the mesh: two meshes of the same layout compare equal across a destroyed
and a new group), the renderer function itself, the static arguments and
the camera uniform's shapes; the uniform is the graph's input and the
renderer's pack what it reads (a new or rewritten volume captures again).
A key whose group has been destroyed is dropped at the next call. NCCL
holds a communicator until every graph that captured one of its
collectives is gone: at world > 1, clear the entries (:func:`clear_steps`)
before ``dist.destroy_process_group``. Every rank must call the entries in
the same order, so that each captures and replays the same collectives.

Renderers are ``(render, pack)`` pairs (:func:`build_default_renderer`,
:func:`build_ray_renderer`) whose route the pack's device sets: K1 (the
hand-written march, ``ops/cuda/march_bonsai``) for a CUDA volume, its plain
version for a CPU one. A pair built once and passed again is what makes a
step replay; a pair made for one call (``renderer=None``) runs the eager
step and caches nothing, as the JAX package's fresh closure caches nothing.
K1 has no slab window: the JAX package's TPU window arguments
(``force_oracle``, ``win_rows``, ``full_frame``) and the window overflow
count it all-reduces have no counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops.cuda import march_bonsai

# the JAX package's functools.lru_cache(maxsize=64) around each jitted step
MAX_KEYS = 64
VIEWS_STEPS = CompiledFrame("render_views_sharded", maxsize=MAX_KEYS)
TILED_STEPS = CompiledFrame("render_frame_tiled", maxsize=MAX_KEYS)


def make_mesh(views: int | None = None, tiles: int = 1, *, device):
    """A (views, tiles) DeviceMesh of ``device``'s type over the initialized
    process group, whose world size must be views x tiles (views defaults to
    world / tiles). The group must carry a backend for that device type
    (NCCL or gloo for "cuda", gloo for "cpu"); a group made with no backend
    named carries its machine's: NCCL where there is a card. A CUDA
    ``device`` with an index becomes this process's current card."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    device = torch.device(device)
    # e.g. "cuda:nccl", or "cpu:gloo,cuda:gloo" for a gloo group
    config = dist.get_backend_config()
    served = {part.split(":")[0] for part in config.split(",")}
    if device.type not in served:
        raise RuntimeError(f"the process group ({config}) has no backend for {device.type}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device")
        if device.index is not None:
            torch.cuda.set_device(device)
    n = dist.get_world_size()
    if views is None:
        views = n // tiles
    if views * tiles != n:
        raise ValueError(f"{views}x{tiles} != {n} processes")
    return init_device_mesh(device.type, (views, tiles), mesh_dim_names=("views", "tiles"))


def _dim_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name`` (``mesh[name]`` would build
    a sub-mesh, ~0.25 ms of host time a call)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_groups(mesh) -> tuple:
    """The process groups of ``mesh``'s dimensions, in order: what a
    compiled step's key holds of the mesh."""
    return tuple(mesh.get_group(name) for name in mesh.mesh_dim_names)


def destroyed(groups) -> bool:
    """Whether any of the process groups ``groups`` has been destroyed (is no
    longer in torch.distributed's registry of groups): a compiled step keyed
    on it is dropped."""
    live = dist.distributed_c10d._world.pg_map
    return any(g not in live for g in groups)


def _stale(key) -> bool:
    return destroyed(key[0])


def clear_steps() -> None:
    """Drop every compiled sharded step, releasing its graph (and NCCL's
    hold on the communicators it captured)."""
    VIEWS_STEPS.clear()
    TILED_STEPS.clear()


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the ``device`` it was made for (a
    CUDA mesh's is the current card)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def orbit_cameras(n_views: int, target=(0.5, 0.5, 0.5), zoom=1.0, pitch=0.5,
                  aspect=1.0) -> list:
    """N cameras orbiting the target in yaw, camera i at yaw 2 pi i / n."""
    return [Camera(zoom=zoom, pitch=pitch, yaw=2.0 * math.pi * i / n_views, target=target,
                   aspect=aspect) for i in range(n_views)]


def orbit_camera_batch(n_views: int, target=(0.5, 0.5, 0.5), zoom=1.0, pitch=0.5,
                       aspect=1.0, *, device) -> CameraUniform:
    """N cameras orbiting the target in yaw — BASELINE config 5's batched
    views (and config 4's orbiting camera, sampled at n frames): one
    :class:`CameraUniform` on ``device`` with a leading (n_views,) batch
    axis, view i at yaw 2 pi i / n, as the JAX package's pytree."""
    return CameraUniform.stack(c.uniform(device) for c in
                               orbit_cameras(n_views, target, zoom, pitch, aspect))


def build_default_renderer(vol_u8, device):
    """``(render, pack)`` with ``render(pack, camera_uniform, width, height,
    max_steps, srgb=True)``: the eager exact frame
    (:func:`march_bonsai.render_frame`), K1 on a CUDA ``device`` and its
    plain version on the CPU; a batched uniform renders all its views in
    one call. It is eager so that a sharded step captures it whole, with
    its collectives, into one graph; build the pair once and pass it to
    every call, so that the step replays."""
    pack = march_bonsai.volume_tensor(vol_u8, device)

    def render(pk, camera_uniform, width, height, max_steps=None, srgb=True):
        return march_bonsai.render_frame(pk, camera_uniform, width, height, max_steps, srgb)

    return render, pack


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dim 0, in rank
    order, written by the collective straight into one tensor."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def views_sharded_step(mesh, render, pack, cams, width: int, height: int,
                       max_steps: int = 64, gather: bool = False):
    """The eager step of :func:`render_views_sharded` (the JAX package's
    ``local_step`` of ``_views_sharded_fn``): this rank's block of views in
    one render call, all-gathered over 'views' with ``gather=True``."""
    n_ranks = _dim_size(mesh, "views")
    if len(cams) % n_ranks:
        raise ValueError(f"{len(cams)} views do not split over {n_ranks} ranks")
    per = len(cams) // n_ranks
    rank = mesh.get_local_rank("views")
    imgs = render(pack, cams[rank * per:(rank + 1) * per], width, height, max_steps)
    if gather:
        imgs = _all_gather(imgs, mesh.get_group("views"))
    return imgs


def render_views_sharded(mesh, render, pack, cams, width: int, height: int,
                         max_steps: int = 64, gather: bool = False):
    """Render a batch of views, sharded over the mesh's 'views' dimension.

    ``(render, pack)``: a renderer pair (:func:`build_default_renderer`)
    whose render takes a batched uniform; ``cams``: a batched
    :class:`CameraUniform` (:func:`orbit_camera_batch`), its number of views
    a multiple of the 'views' size. Each rank renders its contiguous block
    in one call (ranks along 'tiles' render the same block) and returns it
    as (block, H, W, 4); with ``gather=True`` every rank returns all views,
    (n_views, H, W, 4). On a card it replays :func:`views_sharded_step`'s
    graph of the key (the mesh's groups, ``render``, ``width``, ``height``,
    ``max_steps``, ``gather``, the batch's size); pass the same pair on
    every call."""
    VIEWS_STEPS.drop(_stale)
    key = (mesh_groups(mesh), render, width, height, max_steps, gather)
    return VIEWS_STEPS(
        key, lambda c: views_sharded_step(mesh, render, pack, c, width, height, max_steps,
                                          gather), (cams,), reads=pack)


def build_ray_renderer(vol_u8, device):
    """``(render_rays, pack)`` with the ray-set signature ``render_rays(pack,
    eye, (dx, dy, dz), max_steps)`` -> (H, W, 4):
    :func:`march_bonsai.render_bonsai_rays_cuda`, K1 on a CUDA ``device``
    and its plain version on the CPU. This is what
    :func:`render_frame_tiled` marches each rank's band with."""
    pack = march_bonsai.volume_tensor(vol_u8, device)

    def render_rays(pk, eye, dxyz, max_steps=None):
        return march_bonsai.render_bonsai_rays_cuda(
            pk, eye, tuple(d.contiguous() for d in dxyz), max_steps=max_steps)

    return render_rays, pack


def frame_tiled_step(mesh, render_rays, pack, cam: CameraUniform, width: int, height: int,
                     max_steps: int = 64):
    """The eager step of :func:`render_frame_tiled` (the JAX package's
    ``local_step`` of ``_frame_tiled_fn``, with the ray planes): the frame's
    rays, this 'tiles' rank's band marched and the bands all-gathered over
    'tiles'."""
    n_tiles = _dim_size(mesh, "tiles")
    assert height % n_tiles == 0
    eye, dxyz = geometry.rays_fragment_soa(cam, width, height)
    rows = height // n_tiles
    r = mesh.get_local_rank("tiles")
    img = render_rays(pack, eye, tuple(d[r * rows:(r + 1) * rows] for d in dxyz),
                      max_steps=max_steps)
    return _all_gather(img, mesh.get_group("tiles"))


def render_frame_tiled(mesh, vol, cam: CameraUniform, width: int, height: int,
                       max_steps: int = 64, renderer=None):
    """Render ONE frame with its rows sharded over the mesh's 'tiles'
    dimension — the multi-device descendant of the xor demo's 256^2-tile
    dispatch (examples/xor/main.rs:235-254). Every rank makes the frame's
    rays (:func:`geometry.rays_fragment_soa`); 'tiles' rank r marches rows
    [r H/n, (r+1) H/n); the all-gather over the 'tiles' group assembles the
    frame on every rank.

    ``renderer``: optional ``(render_rays, pack)`` from
    :func:`build_ray_renderer`; with it, a card replays
    :func:`frame_tiled_step`'s graph of the key (the mesh's groups,
    ``render_rays``, ``width``, ``height``, ``max_steps``), so pass a pair
    built once. By default a pair is built from ``vol`` on this rank's
    device for this call only: the eager step runs and nothing is cached."""
    if renderer is None:
        render_rays, pack = build_ray_renderer(vol, mesh_device(mesh))
        return frame_tiled_step(mesh, render_rays, pack, cam, width, height, max_steps)
    render_rays, pack = renderer
    TILED_STEPS.drop(_stale)
    key = (mesh_groups(mesh), render_rays, width, height, max_steps)
    return TILED_STEPS(
        key, lambda u: frame_tiled_step(mesh, render_rays, pack, u, width, height, max_steps),
        (cam,), reads=pack)


def multi_view_step(mesh, vol, n_views: int, width: int, height: int, max_steps: int = 32,
                    gather: bool = True, renderer=None):
    """The full multi-device 'step': a batched orbit uniform -> view-sharded
    render (one K1 launch a rank) -> gathered frames. ``renderer``: optional
    ``(render, pack)``, with which a card replays
    :func:`render_views_sharded`'s graph; by default
    :func:`build_default_renderer` of ``vol`` on this rank's device is built
    for this call only, and :func:`views_sharded_step` runs eagerly,
    caching nothing."""
    device = mesh_device(mesh)
    cams = orbit_camera_batch(n_views, device=device)
    if renderer is None:
        render, pack = build_default_renderer(vol, device)
        return views_sharded_step(mesh, render, pack, cams, width, height,
                                  max_steps=max_steps, gather=gather)
    render, pack = renderer
    return render_views_sharded(mesh, render, pack, cams, width, height,
                                max_steps=max_steps, gather=gather)
