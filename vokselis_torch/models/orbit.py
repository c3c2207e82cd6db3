"""Config 4: the 256^3 bonsai on an orbiting camera at 1920x1080, exact and
hybrid (the counterpart of ``bench.py:229-309``, ``bench_bonsai_orbit``).

The orbit is the camera path of ``bench_bonsai_orbit``: n cameras (8 by
default) at zoom 1, pitch 0.5, yaw 2 pi i / n around the volume's centre, at the
frame's aspect (:func:`vokselis_torch.parallel.orbit_camera_batch`). Per pose
:class:`BonsaiOrbit` renders the exact frame (K1) and the hybrid frame at the
reference's operating intermediate (I=1024, ``OPPOINT.json``) and twice its
budget, 2 x 64 tiles (1080p has about twice the 32x32 tiles of 1024^2,
``bench.py:276-280``), and the per-pose mean |hybrid - exact| over rgb that
``bench.py`` gates the hybrid on.

The hybrid frame is what :class:`vokselis_torch.ops.hybrid.HybridBonsaiRenderer`
renders at that pose: a pose that breaks the shear-warp factorization at
every intermediate it may escalate to is rendered by K1 (its route is
"exact"), and that frame is the exact frame already in hand. ``bench.py`` instead drops the hybrid from config 4 when any pose
is degenerate; :attr:`OrbitFrames.bench_gate` says whether its gate passes.
This module renders and returns frames; it times nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.parallel.sharding import orbit_camera_batch, orbit_cameras
from vokselis_torch.volume.io import get_bonsai

WIDTH, HEIGHT = 1920, 1080
N_POSES = 8
INTERMEDIATE = 1024  # OPPOINT.json's operating point: I=1024, budget 64
BUDGET = 2 * 64
CONTRACT = 1e-3  # the hybrid's per-pose mean |hybrid - exact| over rgb


def orbit_poses(n_poses: int = N_POSES, width: int = WIDTH, height: int = HEIGHT, *,
                device="cuda"):
    """``bench_bonsai_orbit``'s camera path: the poses' batched uniform on
    ``device`` (index it for one pose's)."""
    return orbit_camera_batch(n_poses, aspect=width / height, device=device)


@dataclass
class OrbitFrames:
    """One pass over the orbit: per pose the exact frame, the hybrid frame,
    the hybrid's route (:meth:`HybridBonsaiRenderer.route`) and its mean
    |hybrid - exact| over rgb (``errors``, an (n_poses,) float32 tensor on
    the frames' device)."""

    exact: list
    hybrid: list
    routes: list
    errors: torch.Tensor

    @property
    def max_error(self) -> float:
        return float(self.errors.max())

    @property
    def degenerate(self) -> list:
        """The poses whose route is not "hybrid": those K1 rendered ("exact",
        "dense") and those whose hybrid frame escalated to a larger
        intermediate ("escalated", still a hybrid frame). At config 4's
        I=1024 nothing escalates, so these are the poses K1 rendered."""
        return [i for i, r in enumerate(self.routes) if r[0] != "hybrid"]

    @property
    def bench_gate(self) -> bool:
        """``bench.py``'s condition for timing the hybrid: no degenerate
        pose and every pose's error within the contract."""
        return not self.degenerate and self.max_error <= CONTRACT


class BonsaiOrbit:
    """Config 4's renderers over one volume: ``exact`` (K1) and ``hybrid``
    (K34, K5 and K2; K1 at degenerate poses), both on ``device``, and the
    orbit's ``poses``, a list of one uniform per pose (the caller's uniforms
    or batch, by default each pose's own ``Camera.uniform()``, as
    ``bench.py:283-286`` makes them, whose host mirrors let the hybrid
    route the pose without a device read): each pose routes on its own. On a card the poses replay two
    CUDA graphs, the exact frame's and the hybrid frame's. ``vol``: a
    (D, D, D) uint8 volume, by default the 256^3 bonsai."""

    def __init__(self, vol=None, device="cuda", width: int = WIDTH, height: int = HEIGHT,
                 intermediate: int = INTERMEDIATE, budget: int = BUDGET, poses=None):
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.hybrid = HybridBonsaiRenderer(get_bonsai() if vol is None else vol, self.device,
                                           intermediate=intermediate, budget=budget)
        self.exact = self.hybrid.exact
        self.poses = ([c.uniform(self.device)
                       for c in orbit_cameras(N_POSES, aspect=width / height)]
                      if poses is None else list(poses))

    @torch.no_grad()
    def __call__(self) -> OrbitFrames:
        """Render every pose: the exact frame, the hybrid frame and its error
        against the exact one. A pose that the hybrid routes to K1 takes the
        exact frame as its hybrid frame."""
        w, h = self.width, self.height
        exact, frames, routes = [], [], []
        for u in self.poses:
            route = self.hybrid.route(u, w, h)
            img = self.exact(u, w, h)
            exact.append(img)
            frames.append(img if route[0] in ("exact", "dense")
                          else self.hybrid(u, w, h, route=route))
            routes.append(route)
        errors = torch.stack([(f[..., :3] - e[..., :3]).abs().mean()
                              for f, e in zip(frames, exact)])
        return OrbitFrames(exact, frames, routes, errors)
