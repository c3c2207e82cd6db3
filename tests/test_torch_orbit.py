"""Config 4, the bonsai orbit (vokselis_torch.models.orbit), against the JAX
package, and the hybrid frame at frames whose sides are not multiples of the
32-pixel tile.

Config 4 renders at 1920x1080, whose 1080 rows leave a partial last tile
row. Here the orbit runs at 200x113 and 160x90 (partial last tile row and
column) on the 64^3 bonsai, I=256 and a budget of 3 tiles, on the first 3
poses of bench_bonsai_orbit's 8-pose camera path: pose 1 (yaw pi/4) breaks
the shear-warp factorization there, as it does at 1920x1080 and I=1024, and
the hybrid renders it with the exact march. On the CPU every kernel wrapper
takes its plain version. The JAX side runs as its own tests run it on the
CPU: the Pallas kernels in interpret mode (test_pallas.py:16-38), the oracle
march in jnp. The camera uniforms are bitwise the JAX package's.
"""

import importlib
import inspect
import math
import os
import sys

import numpy as np
import pytest
import torch

from vokselis_torch.models import orbit as orbit_model
from vokselis_torch.ops import hybrid as hy
from vokselis_torch.ops.shear_warp import pose_hint
from vokselis_torch.volume.io import get_bonsai

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS, II, BUDGET, N_POSES = 64, 256, 3, 3
EXACT_MEAN = 1e-5  # the exact path's mean error against the oracle (PARITY_REPORT.md)
# the hybrid frame against the JAX package's: the fast frames differ by bf16
# rounding (tests/test_torch_hybrid.py::test_hybrid_matches_jax)
HYB_MAX, HYB_MEAN = 2e-2, 3e-4


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
def jax_interp():
    """The JAX package's march_bonsai, warp2d and hybrid modules reloaded
    with every pallas_call in interpret mode (test_pallas.py:16-38), and
    reloaded back afterwards."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    names = ("vokselis_tpu.ops.pallas.march_bonsai", "vokselis_tpu.ops.pallas.warp2d",
             "vokselis_tpu.ops.hybrid")
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        mods = [importlib.reload(importlib.import_module(m)) for m in names]
        yield dict(zip(("mb", "w2", "hy"), mods))
    finally:
        pl.pallas_call = orig
        for m in names:
            importlib.reload(importlib.import_module(m))


def _bench():
    """bench.py as a module (it imports JAX only inside its functions)."""
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("bench")
    finally:
        sys.path.remove(ROOT)


def _jax_orbit_camera(i, n_poses, aspect):
    from vokselis_tpu.core.camera import Camera as JaxCamera

    # bench.py:285-288, the hybrid gate's poses
    return JaxCamera(zoom=1.0, pitch=0.5, yaw=2.0 * math.pi * i / n_poses,
                     target=(0.5, 0.5, 0.5), aspect=aspect)


def test_orbit_config_matches_bench():
    """Config 4's frame, pose count, intermediate and budget are
    bench_bonsai_orbit's: its defaults, OPPOINT.json's I and twice its budget."""
    bench = _bench()
    params = inspect.signature(bench.bench_bonsai_orbit).parameters
    assert (params["width"].default, params["height"].default, params["n_poses"].default) == (
        orbit_model.WIDTH, orbit_model.HEIGHT, orbit_model.N_POSES)
    op = bench._load_oppoint()
    assert orbit_model.INTERMEDIATE == int(op["ii"])
    assert orbit_model.BUDGET == 2 * int(op["budget"])


@pytest.mark.parametrize("n_poses", [3, 8])
def test_orbit_poses_match_bench_camera_path(n_poses):
    """orbit_poses is bench_bonsai_orbit's camera path: on its first 3 poses
    bitwise the JAX package's orbit_camera_batch(n, aspect=w/h) (the exact
    loop's cameras) and the hybrid gate's Camera per pose."""
    pytest.importorskip("jax")
    from vokselis_tpu.parallel.sharding import orbit_camera_batch as jax_orbit

    w, h = orbit_model.WIDTH, orbit_model.HEIGHT
    port = orbit_model.orbit_poses(n_poses, w, h, device="cpu")
    batch = jax_orbit(n_poses, aspect=w / h)
    assert len(port) == n_poses
    for i in range(3):
        ju = _jax_orbit_camera(i, n_poses, w / h).uniform()
        for name in ("view_position", "proj_view", "inv_proj"):
            got = getattr(port[i], name).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(batch, name)[i]))
            np.testing.assert_array_equal(got, np.asarray(getattr(ju, name)))


def test_orbit_degenerate_poses_match_jax():
    """At 1920x1080, I=1024 and the 256^3 volume the port classifies every
    orbit pose as the JAX package's pose_hint does: the poses at yaw pi/4 +
    k pi/2 break the factorization, so bench.py's config-4 gate (no
    degenerate pose) drops the hybrid, and the port's hybrid renders those
    poses with the exact march."""
    pytest.importorskip("jax")
    from vokselis_tpu.ops.shear_warp import pose_hint as jax_pose_hint

    w, h, n = orbit_model.WIDTH, orbit_model.HEIGHT, orbit_model.N_POSES
    port = [pose_hint(u, w, h, orbit_model.INTERMEDIATE, 256)[2]
            for u in orbit_model.orbit_poses(n, w, h, device="cpu")]
    want = [jax_pose_hint(_jax_orbit_camera(i, n, w / h).uniform(), w, h,
                          orbit_model.INTERMEDIATE, 256)[2] for i in range(n)]
    assert port == want == [i % 2 == 1 for i in range(n)]


def _jax_stats_rows(stats_packed):
    return np.asarray(stats_packed).reshape(-1, 8, 128)[:, :5, 0]


def _jax_selected(jhy, packs, ju, w, h):
    """The JAX hybrid's selected tile ids at this pose, from its own fast
    frame's stats (hybrid.py:212-298), as tests/test_torch_hybrid.py
    computes them."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.shear_warp import _render_fast as jax_render_fast

    _, statsp = jax_render_fast(packs, ju, w, h, II, False, return_aux="stats")
    ny, nx = -(-h // 32), -(-w // 32)
    st = jnp.asarray(_jax_stats_rows(statsp))
    scores = (st[:, 0] + 0.03 * st[:, 1]) / 1024.0 + (
        ((st[:, 3] + 4.0 * st[:, 2]) / 1024.0).reshape(ny, nx)
        * jhy._dilate3(st[:, 4].reshape(ny, nx))).reshape(-1)
    return np.asarray(jhy.select_units(scores, ny * nx, BUDGET, jnp.float32(hy.DEFAULT_THRESH),
                                       False))


@pytest.mark.parametrize("size", [(200, 113), (160, 90)], ids=["200x113", "160x90"])
def test_orbit_frames_match_jax(jax_interp, size):
    """The orbit at a frame of partial tiles, on its first 3 poses: each
    exact frame within EXACT_MEAN of the JAX oracle; each hybrid frame within
    the hybrid's contract (mean <= 1e-3 over rgb) of the port's exact frame,
    the errors the entry point returns, and within HYB_MAX / HYB_MEAN of the
    JAX package's hybrid on the same pose; at the hybrid-routed poses at
    least 2 of the 3 tile picks agree with the JAX selection (the fast
    frames differ by bf16 rounding where scores nearly tie); at the
    degenerate pose the hybrid frame is the exact one."""
    import jax.numpy as jnp
    from vokselis_tpu.ops.reference import render_bonsai as jax_render_bonsai

    w, h = size
    vol = get_bonsai(DIMS)
    poses = orbit_model.orbit_poses(8, w, h, device="cpu")[:N_POSES]
    orb = orbit_model.BonsaiOrbit(vol, "cpu", w, h, intermediate=II, budget=BUDGET,
                                  poses=poses)
    frames = orb()
    assert [r[0] for r in frames.routes] == ["hybrid", "exact", "hybrid"]
    assert frames.degenerate == [1] and not frames.bench_gate
    assert tuple(frames.errors.shape) == (N_POSES,)
    assert not hy._pair_mode(DIMS, w, h)
    jhy = jax_interp["hy"]
    jax_r = jhy.HybridBonsaiRenderer(vol, intermediate=II, budget=BUDGET)
    for i, u in enumerate(poses):
        ju = _jax_orbit_camera(i, 8, w / h).uniform()
        exact, hyb = frames.exact[i], frames.hybrid[i]
        assert exact.shape == hyb.shape == (h, w, 4)
        assert bool(torch.isfinite(hyb).all())
        oracle = np.asarray(jax_render_bonsai(jnp.asarray(vol), ju, width=w, height=h))
        assert np.abs(exact.numpy()[..., :3] - oracle[..., :3]).mean() <= EXACT_MEAN, i
        err = float((hyb[..., :3] - exact[..., :3]).abs().mean())
        assert err == pytest.approx(float(frames.errors[i]), rel=1e-6, abs=0)
        assert err <= orbit_model.CONTRACT, (i, err)
        d = np.abs(hyb.numpy() - np.asarray(jax_r(ju, w, h)))
        assert d.max() <= HYB_MAX and d.mean() <= HYB_MEAN, (i, d.max(), d.mean())
        if frames.routes[i][0] != "hybrid":
            assert torch.equal(hyb, exact)
            continue
        _, _, ids = hy._render_hybrid(orb.hybrid.packs, orb.hybrid.vol, u, orb.hybrid.thresh,
                                      w, h, II, BUDGET, True)
        jids = _jax_selected(jhy, jax_r.packs, ju, w, h)
        assert len(set(ids.tolist()) & set(jids.tolist())) >= 2, (ids.tolist(), jids.tolist())
