"""Config 5: a time-varying 512^3 volume rendered from 64 views at 512^2 per
batch (the counterpart of ``bench.py:312-371``, ``bench_views_512``).

Each batch step regenerates the u8 density on the device at t = 0.3 b (K8,
:func:`vokselis_torch.ops.cuda.genvol.generate_density_u8`, the reference's
per-update compute fill) and renders ``n_views`` orbit views of it with the
exact march, each ray allowed the full diagonal of steps: one ray pass over
the batched uniform of the views and one K1 launch for all of them (whose
occupancy table of the new volume is built first), the counterpart of the
JAX package's ``vmap`` of its render. The step uploads nothing from the host
(t is filled on the device), and on a card it replays as one CUDA graph
(:meth:`ViewsBatch.step` is the eager step), t copied into the graph's 0-d
input. With a ``mesh``
(:func:`vokselis_torch.parallel.make_mesh`) the views are sharded over its
'views' dimension (:func:`vokselis_torch.parallel.sharding.views_sharded_step`),
as ``bench.py`` shards them over the JAX mesh, and the step replays the same
way: one graph per key, the key holding the mesh's process groups, with the
all-gather's NCCL collective inside it. The TPU's slab-layout repack has
no counterpart: K1 reads the volume as it is. This module renders and
returns frames; it times nothing.
"""

from __future__ import annotations

import torch

from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.ops.cuda.genvol import generate_density_u8
from vokselis_torch.ops.reference import bonsai_max_steps
from vokselis_torch.parallel.sharding import (
    build_default_renderer,
    destroyed,
    mesh_device,
    mesh_groups,
    orbit_camera_batch,
    views_sharded_step,
)

N_VIEWS = 64
VIEW_RES = 512
DIMS = 512


def full_diagonal(dims: int) -> int:
    """Steps for a ray across the whole box diagonal (bench.py:340)."""
    return bonsai_max_steps((dims, dims, dims))


class ViewsBatch:
    """Config 5's batch step over ``n_views`` orbit views (aspect 1) at
    ``view_res``^2 of a ``dims``^3 volume, on ``device``, or on ``mesh``'s
    device with the views sharded over its 'views' dimension (each rank then
    returns its block of views). ``cams`` is the views' batched uniform."""

    def __init__(self, n_views: int = N_VIEWS, view_res: int = VIEW_RES, dims: int = DIMS,
                 device="cuda", mesh=None):
        self.device = mesh_device(mesh) if mesh is not None else torch.device(device)
        self.n_views, self.view_res, self.dims = n_views, view_res, dims
        self.mesh = mesh
        self.max_steps = full_diagonal(dims)
        self.cams = orbit_camera_batch(n_views, device=self.device)
        self.compiled = CompiledFrame("ViewsBatch")

    @torch.no_grad()
    def step(self, t):
        """The eager batch step at time ``t`` (a 0-d float32 tensor on the
        device): ``(volume, views)``, the (D, D, D) uint8 volume and the
        (n, view_res, view_res, 4) float32 frames (with a mesh, this rank's
        block of them)."""
        vol = generate_density_u8(t, self.dims)  # bench.py:348-350
        render, pack = build_default_renderer(vol, self.device)
        res, steps = self.view_res, self.max_steps
        if self.mesh is not None:
            return vol, views_sharded_step(self.mesh, render, pack, self.cams, res, res,
                                           max_steps=steps)
        return vol, render(pack, self.cams, res, res, steps)

    def __call__(self, b=0):
        """Batch step ``b`` (t = 0.3 b): :meth:`step`, replayed on a card from
        its CUDA graph, with or without a mesh (the key then holds the mesh's
        process groups, and a key of a destroyed group is dropped)."""
        t = torch.full((), 0.3 * b, dtype=torch.float32, device=self.device)
        key = ("step", self.n_views, self.view_res, self.dims)
        if self.mesh is not None:
            self.compiled.drop(lambda k: destroyed(k[-1]))
            key += (mesh_groups(self.mesh),)
        return self.compiled(key, self.step, (t,), reads=self.cams, id=b)
