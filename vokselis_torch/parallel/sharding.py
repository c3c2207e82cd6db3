"""Multi-device rendering over ``torch.distributed``: batched multi-view and
row-sharded single frames.

The port of ``vokselis_tpu/parallel/sharding.py``. The JAX package runs one
program over a ``("views", "tiles")`` device mesh with ``shard_map``; here
each device is a process of an initialized process group (NCCL on CUDA
cards, gloo on the CPU) and :func:`make_mesh` lays a
``torch.distributed.device_mesh.DeviceMesh`` of the device its caller names,
with the same two dimension names, over its ranks:

- BASELINE.json config 5 (batched 64-view rendering) -> data parallelism
  over 'views': each rank renders its contiguous block of the views with
  the unchanged single-device renderer (``P("views")``); ``gather=True``
  all-gathers the frames over the 'views' group, so every rank holds all;
- image-space tile sharding -> each 'tiles' rank marches its band of frame
  ROWS (rays are independent: no halo exchange); an all-gather over the
  'tiles' group assembles the frame, an all-reduce the overflow count.

Renderers are ``(render, pack)`` pairs (:func:`build_default_renderer`,
:func:`build_ray_renderer`) whose route the pack's device sets: K1 (the
hand-written march, ``ops/cuda/march_bonsai``) for a CUDA volume, its plain
version for a CPU one. K1 has no slab window, so the overflow count is
always 0; the interface keeps it, as ``BonsaiRenderer.last_overflow`` does.
The JAX package's TPU window arguments (``force_oracle``, ``win_rows``,
``full_frame``) have no counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from vokselis_torch.core import geometry
from vokselis_torch.core.camera import Camera, CameraUniform
from vokselis_torch.ops.cuda import march_bonsai
from vokselis_torch.ops.reference import MAX_STEPS_BONSAI


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


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the ``device`` it was made for (a
    CUDA mesh's is the current card)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def orbit_camera_batch(n_views: int, target=(0.5, 0.5, 0.5), zoom=1.0, pitch=0.5,
                       aspect=1.0, *, device) -> list[CameraUniform]:
    """N cameras orbiting the target in yaw — BASELINE config 5's batched
    views (and config 4's orbiting camera, sampled at n frames): the
    uniform of view i at yaw 2 pi i / n, on ``device``. (The JAX package
    stacks them into one pytree with a batch axis; the port keeps one
    :class:`CameraUniform` per view.)"""
    return [Camera(zoom=zoom, pitch=pitch, yaw=2.0 * math.pi * i / n_views, target=target,
                   aspect=aspect).uniform(device)
            for i in range(n_views)]


def build_default_renderer(vol_u8, device):
    """``(render, pack)`` with ``render(pack, camera_uniform, width, height,
    max_steps)``: :func:`march_bonsai.build_renderer`, K1 on a CUDA
    ``device`` and its plain version on the CPU."""
    return march_bonsai.build_renderer(vol_u8, device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dim 0, in rank
    order, written by the collective straight into one tensor."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def render_views_sharded(mesh, render, pack, cams, width: int, height: int,
                         max_steps: int = 64, gather: bool = False):
    """Render a batch of views, sharded over the mesh's 'views' dimension.

    ``(render, pack)``: a renderer pair (:func:`build_default_renderer`);
    ``cams``: one uniform per view, their number a multiple of the 'views'
    size. Each rank renders its contiguous block (ranks along 'tiles' render
    the same block) and returns it as (block, H, W, 4); with ``gather=True``
    every rank returns all views, (n_views, H, W, 4)."""
    n_ranks = _dim_size(mesh, "views")
    if len(cams) % n_ranks:
        raise ValueError(f"{len(cams)} views do not split over {n_ranks} ranks")
    per = len(cams) // n_ranks
    rank = mesh.get_local_rank("views")
    imgs = torch.stack([render(pack, c, width, height, max_steps)
                        for c in cams[rank * per:(rank + 1) * per]])
    if gather:
        imgs = _all_gather(imgs, mesh.get_group("views"))
    return imgs


def build_ray_renderer(vol_u8, device, with_overflow: bool = False):
    """``(render_rays, pack)`` with the ray-set signature ``render_rays(pack,
    eye, (dx, dy, dz), max_steps)`` -> (H, W, 4), or ``((H, W, 4), 0)`` with
    ``with_overflow=True``: :func:`march_bonsai.render_bonsai_rays_cuda`, K1
    on a CUDA ``device`` and its plain version on the CPU. This is what
    :func:`render_frame_tiled` marches each rank's band with."""
    pack = march_bonsai.volume_tensor(vol_u8, device)

    def render_rays(pk, eye, dxyz, max_steps=MAX_STEPS_BONSAI):
        img = march_bonsai.render_bonsai_rays_cuda(
            pk, eye, tuple(d.contiguous() for d in dxyz), max_steps=max_steps)
        return (img, 0) if with_overflow else img

    return render_rays, pack


def render_frame_tiled(mesh, vol, cam: CameraUniform, width: int, height: int,
                       max_steps: int = 64, renderer=None, with_overflow: bool = False):
    """Render ONE frame with its rows sharded over the mesh's 'tiles'
    dimension — the multi-device descendant of the xor demo's 256^2-tile
    dispatch (examples/xor/main.rs:235-254). Every rank makes the frame's
    rays (:func:`geometry.rays_fragment_soa`); 'tiles' rank r marches rows
    [r H/n, (r+1) H/n); the all-gather over the 'tiles' group assembles the
    frame on every rank.

    ``renderer``: optional ``(render_rays, pack)`` from
    :func:`build_ray_renderer`; by default one is built from ``vol`` on this
    rank's device. ``with_overflow=True`` returns ``(frame, overflow)``:
    the all-reduced count of the ranks' window overflows, always 0 for K1,
    which has no window."""
    n_tiles = _dim_size(mesh, "tiles")
    assert height % n_tiles == 0
    render_rays, pack = (renderer if renderer is not None
                         else build_ray_renderer(vol, mesh_device(mesh), with_overflow=True))
    eye, dxyz = geometry.rays_fragment_soa(cam, width, height)
    rows = height // n_tiles
    r = mesh.get_local_rank("tiles")
    out = render_rays(pack, eye, tuple(d[r * rows:(r + 1) * rows] for d in dxyz),
                      max_steps=max_steps)
    img, ovf = out if isinstance(out, tuple) else (out, 0)
    group = mesh.get_group("tiles")
    img = _all_gather(img, group)
    # a fill on the device: a tensor built from a host value would wait for the march
    ovf = torch.full((), int(ovf), dtype=torch.int32, device=img.device)
    dist.all_reduce(ovf, group=group)
    return (img, ovf) if with_overflow else img


def multi_view_step(mesh, vol, n_views: int, width: int, height: int, max_steps: int = 32,
                    gather: bool = True, renderer=None):
    """The full multi-device 'step': orbit cameras -> view-sharded render ->
    gathered frames. ``renderer``: optional ``(render, pack)``; by default
    :func:`build_default_renderer` of ``vol`` on this rank's device."""
    device = mesh_device(mesh)
    render, pack = renderer if renderer is not None else build_default_renderer(vol, device)
    cams = orbit_camera_batch(n_views, device=device)
    return render_views_sharded(mesh, render, pack, cams, width, height,
                                max_steps=max_steps, gather=gather)
