"""The steep probe class (zoom 1.0, pitch 1.2; tools/cpu_minisweep.py:67-69)
at yaw 0, 256x256, I=256, on the full 256^3 bonsai: where the port's hybrid
and the JAX package's hybrid on the CPU pick different tiles, and why.

The JAX package's CPU frame does not run its Pallas kernels: ``_render_fast``
takes its XLA branch off the TPU (vokselis_tpu/ops/shear_warp.py:387-423),
which rounds the hat weights to bf16 but leaves the resampled products in
float32. The TPU's kernel (ops/pallas/shear_resample.py:117-167) rounds
each tap row's sum and the sample to bf16, and so does the port's K3. Under
the centre tiles 35 and 36 of the 8x8 tile grid the slabs are flat (irho is
clamped to 1 there), the rounded resample is one value per slab, and the
composited intermediate is one constant rgba: its curvature is exactly 0
and the tiles score 0. The XLA branch's unrounded products ripple over the
same texels, which gives those tiles (and their neighbours 43 and 44) a
curvature score above the hybrid's threshold. So at this pose the port
follows the JAX package's Pallas path, which these tests run in interpret
mode, and differs from its CPU frame only in those four tiles. The
curvature score cannot see error in a flat, saturated region: that blind
spot is the reference's own.
"""

import math

import numpy as np
import pytest
import torch

from vokselis_torch.core.camera import CameraUniform
from vokselis_torch.ops import hybrid as hy
from vokselis_torch.ops import shear_warp
from vokselis_torch.ops.cuda import shear_resample as sr
from vokselis_torch.ops.cuda import warp2d
from vokselis_torch.volume.io import get_bonsai

SIZE = II = 256
STEEP = dict(zoom=1.0, pitch=1.2, yaw=0.0, target=(0.5, 0.5, 0.5))
CENTRE = (35, 36, 43, 44)  # the tiles whose selection differs
FLAT = (35, 36)  # the tiles over a constant intermediate
NY = NX = SIZE // 32


@pytest.fixture(scope="module")
def steep():
    """The port's geometry, resampled stack and planes at the steep pose,
    the JAX package's Pallas resample and composite (interpret mode) on the
    port's own pack, positions and gates, and the JAX package's stats from
    its CPU frame, on one carried-across camera uniform."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from vokselis_tpu.core.camera import Camera as JaxCamera
    from vokselis_tpu.ops import shear_warp as jsw
    from vokselis_tpu.ops.pallas import shear_resample as jsr

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vol = get_bonsai()
        ju = JaxCamera(aspect=1.0, **STEEP).uniform()
        u = CameraUniform.from_numpy(np.asarray(ju.view_position), np.asarray(ju.proj_view),
                                     np.asarray(ju.inv_proj), "cpu")
        pack = shear_warp.prepare_fast_volume(vol, "cpu")
        geo = shear_warp.fast_geometry(pack, u, SIZE, SIZE, II)
        volm = pack[0][int(geo.m[0])]
        stack = sr.resample_slabs_plain(pack[0], geo.m, geo.pos_u, geo.pos_v, geo.occ_k)
        planes = sr.composite_plain(stack, geo.sgn, geo.irho, geo.occ_rb)
        _, stats = shear_warp._warp_to_screen(planes, geo, False, return_aux="stats")

        gp = geo.pos_u.shape[0]
        res = jsr.resample_slabs(jnp.asarray(volm.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(geo.pos_u.numpy()), jnp.asarray(geo.pos_v.numpy()),
                                 occ=jnp.asarray(geo.occ_k.to(torch.int32).numpy()),
                                 interpret=True)
        jstack = np.asarray(res, np.float32).transpose(0, 2, 1, 3, 4).reshape(gp, II, II)
        occ_b = geo.occ_rb.numpy().reshape(gp // 8, 8, II // 8).any(axis=1).T
        jplanes = np.stack([np.asarray(p) for p in jsr.composite_chunks(
            res, jnp.int32(int(geo.sgn[0])), jnp.asarray(geo.irho.numpy()),
            occ_b=jnp.asarray(occ_b), interpret=True)])
        _, jst = jsw._render_fast(jsw.prepare_fast_volume(vol), ju, SIZE, SIZE, II, False,
                                  return_aux="stats")
        jstats = np.asarray(jst).reshape(-1, 8, 128)[:, :5, 0].copy()
    finally:
        torch.set_num_threads(n_threads)
    return dict(geo=geo, volm=volm, stack=stack, planes=planes, stats=stats.numpy(),
                jstack=jstack, jplanes=jplanes, jstats=jstats)


def _texels(geo, tile):
    """The intermediate texels (v0, v1, u0, u1; inclusive) that the warp
    taps for the ok pixels of screen tile ``tile``."""
    av, bu, ok = shear_warp.warp_coords(geo, II, II)
    ty, tx = divmod(tile, NX)
    rows, cols = slice(32 * ty, 32 * ty + 32), slice(32 * tx, 32 * tx + 32)
    a, b = av[rows, cols][ok[rows, cols]], bu[rows, cols][ok[rows, cols]]
    assert a.numel() > 0
    return (math.floor(float(a.min())), math.floor(float(a.max())) + 1,
            math.floor(float(b.min())), math.floor(float(b.max())) + 1)


def test_steep_resample_is_bitwise_the_tpu_kernel(steep):
    """(i) The port's plain K3 on its own pack, positions and gate at the
    steep pose is bit for bit the JAX package's resample_slabs in interpret
    mode, over every slab."""
    assert steep["stack"].shape == steep["jstack"].shape
    np.testing.assert_array_equal(steep["stack"].float().numpy(), steep["jstack"])
    assert float(steep["stack"].float().max()) > 0.5


def test_steep_centre_intermediate_is_flat(steep):
    """(ii) Under tiles 35 and 36 the port's composited intermediate is one
    constant rgba with zero curvature, and so is the JAX package's Pallas
    composite of the same stack (composite_chunks, interpret mode; the two
    agree within 1e-4 everywhere, test_composite_plain_matches_jax_chunks's
    bound). The slabs there are flat after the TPU's rounding: the first
    slab above 0.1 is one value. The XLA branch's resample of that slab
    (bf16 hat weights, float32 products) ripples over the same texels."""
    geo, planes, jplanes = steep["geo"], steep["planes"], steep["jplanes"]
    assert np.abs(planes.numpy() - jplanes).max() <= 1e-4
    curv = shear_warp.curvature(planes)
    jcurv = shear_warp.curvature(torch.from_numpy(jplanes))
    for tile in FLAT:
        v0, v1, u0, u1 = _texels(geo, tile)
        for p, c in ((planes.numpy(), curv), (jplanes, jcurv)):
            blk = p[:, v0:v1 + 1, u0:u1 + 1].reshape(4, -1)
            assert (blk == blk[:, :1]).all(), tile
            assert float(c[v0:v1 + 1, u0:u1 + 1].abs().max()) == 0.0, tile
        assert float(planes[3, v0, u0]) > 0.95  # saturated

    v0, v1, u0, u1 = _texels(geo, FLAT[0])
    stack = steep["stack"][:, v0:v1 + 1, u0:u1 + 1].float()
    k = int(torch.nonzero(stack.amax(dim=(1, 2)) > 0.1)[0, 0])
    assert torch.unique(stack[k]).numel() == 1
    d = steep["volm"].shape[1]
    cols = np.arange(d, dtype=np.float32)

    def hat(pos):
        w = np.maximum(np.float32(0), np.float32(1) - np.abs(pos[:, None] - cols[None, :]))
        return torch.from_numpy(w).to(torch.bfloat16).float()

    wu = hat(geo.pos_u[k, u0:u1 + 1].numpy())  # (Iu, D)
    wv = hat(geo.pos_v[k, v0:v1 + 1].numpy())  # (Iv, D)
    xla = wv @ (steep["volm"][k].float() @ wu.T)
    assert torch.unique(xla).numel() > 10
    assert float(xla.max() - xla.min()) > 1e-3


def test_steep_stats_differ_only_in_the_centre_tiles(steep):
    """(iii) The port's per-tile stats against the JAX package's from its
    CPU frame (the XLA branch): the counts agree in every tile, and the
    sums outside the four centre tiles agree within 2e-2 of the largest
    tile's (curvature and edge; measured 1.66e-2 and 8.4e-3) and the peak
    within 1e-3 of the largest (measured 4.8e-4). The tiles above the
    hybrid's threshold are the same but for the centre four, which only
    the XLA branch's ripple scores: tiles 35 and 36 have zero curvature
    in the port."""
    st, jst = steep["stats"], steep["jstats"]
    assert st.shape == jst.shape == (NY * NX, warp2d.N_STATS)
    for col in (warp2d.STAT_OVF, warp2d.STAT_EXT):
        np.testing.assert_array_equal(st[:, col], jst[:, col])
    others = [t for t in range(NY * NX) if t not in CENTRE]
    for col, bound in ((warp2d.STAT_CURV, 2e-2), (warp2d.STAT_EDGE, 2e-2),
                       (warp2d.STAT_PEAK, 1e-3)):
        err = np.abs(st[others, col] - jst[others, col]).max()
        assert err <= bound * np.abs(jst[:, col]).max(), (col, err)
    assert (st[list(FLAT), warp2d.STAT_CURV] == 0).all()

    above = set(np.flatnonzero(hy.score_tiles(torch.from_numpy(st), NY, NX).numpy()
                               > hy.DEFAULT_THRESH).tolist())
    jabove = set(np.flatnonzero(hy.score_tiles(torch.from_numpy(jst), NY, NX).numpy()
                                > hy.DEFAULT_THRESH).tolist())
    assert jabove - above == set(CENTRE)
    assert above <= jabove and len(above) >= 10
