"""K8 and K9 read their hashes from the shared table (hash_table.py) through
each brick's shared-memory window; on the CPU.

A plain mirror of the kernels (genvol.cu), brick by brick: each octave's
window comes from genvol.brick_windows and holds table_hash values, each
thread's lattice columns are window indices, and each z walk mixes a
lattice plane's x-y corners once and reuses the mix while the plane stays.
It must equal the plain versions bitwise. The window rule must cover every
lattice argument a brick's voxels read and stay inside HASH_RANGES, and its
capacity bound every window. Every input is made from a numpy seed.
"""

import math

import numpy as np
import pytest
import torch

from vokselis_torch.core.colors import mix, smoothstep
from vokselis_torch.ops.cuda import genvol
from vokselis_torch.ops.cuda import hash_table as ht
from vokselis_torch.ops.cuda import march_field as mf
from vokselis_torch.volume import fields_soa

TIMES = (0.0, math.pi / 2, -math.pi / 2)  # sin t = 0, 1, -1
EPS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread (test_torch_hybrid.py:42-50): the mirror runs many
    small torch ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return ht.build_hash_table("cpu")


def _axis(v):
    """(floor, smoothed fraction) of each octave (genvol.cu axis)."""
    out = []
    for s in (2.01, 2.02, None):
        p = torch.floor(v)
        out.append((p, fields_soa._smooth(v - p)))
        if s is not None:
            v = v * s
    return out


class _Window:
    """One octave's window: hash(n) for n in [base, last] through table_hash;
    a plane read outside it fails (the kernel traps)."""

    def __init__(self, table, octave, base, last):
        n = torch.arange(base, last + 1, dtype=torch.int64).to(torch.float32)
        self.values = ht.table_hash(table, octave, n)
        self.base, self.lim = base, last - base - 158

    def plane(self, i, fx, fy):
        assert int(i.min()) >= 0 and int(i.max()) <= self.lim, "read outside the window"
        w = self.values
        return mix(mix(w[i], w[i + 1], fx), mix(w[i + 157], w[i + 158], fx), fy)


def _mirror(kernel, time, dims, table):
    """K8 (u8 (D, D, D)) or K9 ((density, normal)) as the kernels compute
    them: bricks, windows, plane reuse along each z walk. Voxel centres are
    the plain versions' own."""
    k9 = kernel == "K9"
    sin_t = torch.sin(torch.tensor(time, dtype=torch.float32) * 1.0)
    brick, caps = genvol._brick(genvol.K9_BRICK if k9 else genvol.K8_BRICK, dims, k9)
    windows = genvol.brick_windows(dims, sin_t, brick, offsets=k9)
    length = windows[..., 1] - windows[..., 0] + 1
    assert bool((length <= torch.tensor(caps)).all())
    c = (torch.arange(dims, dtype=torch.float32) - dims / 2.0) / dims
    if k9:
        out = (torch.empty((dims, dims, dims, 4)), torch.empty((dims, dims, dims, 4)))
    else:
        out = torch.empty((dims, dims, dims), dtype=torch.uint8)
    bx, by, bz = brick
    for iz, z0 in enumerate(range(0, dims, bz)):
        for iy, y0 in enumerate(range(0, dims, by)):
            for ix, x0 in enumerate(range(0, dims, bx)):
                wins = [_Window(table, o, int(windows[iz, iy, ix, o, 0]),
                                int(windows[iz, iy, ix, o, 1])) for o in range(3)]
                xs = torch.clamp(torch.arange(x0, x0 + bx), max=dims - 1)
                ys = torch.clamp(torch.arange(y0, y0 + by), max=dims - 1)
                cx, cy = c[xs][None, :], c[ys][:, None]
                ox, oy = cx - EPS, cy - EPS
                ax = _axis((cx + 1.0) * 32.0)
                ay = _axis((cy + sin_t * 0.1) * 32.0)
                axe = _axis((ox + 1.0) * 32.0)
                aye = _axis((oy + sin_t * 0.1) * 32.0)

                def column(px, py, o):
                    return (px + py * 157.0).long() - wins[o].base

                col = [column(ax[o][0], ay[o][0], o) for o in range(3)]
                col_x = [column(axe[o][0], ay[o][0], o) for o in range(3)]
                col_y = [column(ax[o][0], aye[o][0], o) for o in range(3)]
                # the kernel's per-octave state: planes pz and pz + 1 of the
                # value's column (b) and of the offset columns (xo, yo), and
                # plane pz - 1 of the value's column (bm) once known
                st = [dict(key=None, bm=None) for _ in range(3)]
                for z in range(z0, min(z0 + bz, dims)):
                    cz = c[z]
                    oz = cz - EPS
                    az = _axis((cz + 21.0) * 32.0)
                    aze = _axis((oz + 21.0) * 32.0)
                    f = [None] * 4
                    for o in range(3):
                        win, s = wins[o], st[o]
                        pz, pze = int(az[o][0]), int(aze[o][0])
                        fx, fy = ax[o][1], ay[o][1]

                        def planes(p):
                            b = win.plane(col[o] + 113 * p, fx, fy)
                            if not k9:
                                return b, None, None
                            return (b, win.plane(col_x[o] + 113 * p, axe[o][1], fy),
                                    win.plane(col_y[o] + 113 * p, fx, aye[o][1]))

                        if pz != s["key"]:
                            if s["key"] is not None and pz == s["key"] + 1:
                                s["bm"], s["p0"] = s["p1"][0], s["p1"]
                            else:
                                s["bm"], s["p0"] = None, planes(pz)
                            s["p1"] = planes(pz + 1)
                            s["key"] = pz
                        p0, p1 = s["p0"], s["p1"]
                        vals = [mix(p0[0], p1[0], az[o][1])]
                        if k9:
                            zp0, zp1 = p0[0], p1[0]
                            if pze == pz - 1:
                                if s["bm"] is None:
                                    s["bm"] = win.plane(col[o] + 113 * pze, fx, fy)
                                zp0, zp1 = s["bm"], p0[0]
                            elif pze != pz:
                                zp0 = win.plane(col[o] + 113 * pze, fx, fy)
                                zp1 = win.plane(col[o] + 113 * (pze + 1), fx, fy)
                            vals += [mix(p0[1], p1[1], az[o][1]), mix(p0[2], p1[2], az[o][1]),
                                     mix(zp0, zp1, aze[o][1])]
                        amp = (0.5, 0.25, 0.125)[o]
                        f = [amp * v if o == 0 else g + amp * v for g, v in zip(f, vals)]
                    nyx = (slice(0, min(by, dims - y0)), slice(0, min(bx, dims - x0)))
                    region = (z, slice(y0, y0 + by), slice(x0, x0 + bx))

                    def alpha(v, rx, ry, rz):
                        return v * smoothstep(0.5, 0.25, fields_soa._radius(rx, ry, rz))

                    a0 = alpha(f[0], cx, cy, cz)
                    if not k9:
                        q = torch.clamp(a0 * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
                        out[region] = q[nyx]
                        continue
                    gx = a0 - alpha(f[1], ox, cy, cz)
                    gy = a0 - alpha(f[2], cx, oy, cz)
                    gz = a0 - alpha(f[3], cx, cy, oz)
                    nx, ny, nz = fields_soa._normalize(gx, gy, gz)
                    nmag = torch.sqrt(nx * nx + ny * ny + nz * nz)
                    v2 = f[0] / 2.0
                    out[0][region] = torch.stack([v2, v2, v2, a0], dim=-1)[nyx]
                    out[1][region] = torch.stack([nx, ny, nz, nmag], dim=-1)[nyx]
    return out


# -- the mirror against the plain versions ------------------------------------------

@pytest.mark.parametrize("time", TIMES)
@pytest.mark.parametrize("dims", [16, 33])
def test_table_mirror_k8_matches_plain(table, dims, time):
    """K8's mirror (table hashes through brick windows, plane reuse) is
    bitwise generate_density_u8_plain (the sine hash, voxel by voxel)."""
    got = _mirror("K8", time, dims, table)
    want = genvol.generate_density_u8_plain(time, dims, "cpu")
    assert torch.equal(got, want)
    assert int(want.max()) > 50  # the cloud is there


@pytest.mark.parametrize("time", TIMES)
@pytest.mark.parametrize("dims", [16, 33])
def test_table_mirror_k9_matches_plain(table, dims, time):
    """K9's mirror (its offset points' planes included) is bitwise
    generate_xor_volumes_plain (five independent field evaluations)."""
    dens, nrm = _mirror("K9", time, dims, table)
    dens_p, nrm_p = genvol.generate_xor_volumes_plain(time, dims, "cpu")
    assert torch.equal(dens, dens_p) and torch.equal(nrm, nrm_p)


# -- the window rule -----------------------------------------------------------------

def _brick_arguments(dims, sin_t, brick, index, offsets):
    """Per octave, (min, max) of every hash argument n + k the voxels of
    brick ``index`` (bricks along z, y, x) read: their cells' corners and,
    with ``offsets``, those of their one-sided offset points (the
    arguments of fields_soa.noise_volume and gradient at the voxels)."""
    c = (torch.arange(dims, dtype=torch.float32) - dims / 2.0) * genvol._inv(dims)
    axes = [c[torch.arange(i * b, min((i + 1) * b, dims))] for i, b in zip(index[::-1], brick)]
    cx, cy, cz = torch.meshgrid(*axes, indexing="ij")
    points = [(cx, cy, cz)]
    if offsets:
        points += [(cx - EPS, cy, cz), (cx, cy - EPS, cz), (cx, cy, cz - EPS)]
    lo, hi = [math.inf] * 3, [-math.inf] * 3
    for px, py, pz in points:
        x, y, z = fields_soa._lattice(px, py, pz, sin_t)
        for o, s in enumerate((2.01, 2.02, None)):
            n = torch.floor(x) + torch.floor(y) * 157.0 + 113.0 * torch.floor(z)
            lo[o] = min(lo[o], float(n.min()))
            hi[o] = max(hi[o], float(n.max()) + 271.0)
            if s is not None:
                x, y, z = x * s, y * s, z * s
    return lo, hi


@pytest.mark.parametrize("sin_t", [-1.0, 0.0, 1.0, 0.37])
@pytest.mark.parametrize("dims", [256, 512])
@pytest.mark.parametrize("kernel", ["K8", "K9"])
def test_brick_windows_cover_every_read(kernel, dims, sin_t):
    """At the eight corner bricks and 8 random ones, each octave's window
    holds every lattice argument the brick's voxels read (K9's offset cells
    included); every brick's windows lie inside HASH_RANGES and within
    window_capacity."""
    offsets = kernel == "K9"
    default = genvol.K9_BRICK if offsets else genvol.K8_BRICK
    brick, caps = genvol._brick(default, dims, offsets)
    assert brick == default
    win = genvol.brick_windows(dims, sin_t, brick, offsets)
    nb = win.shape[:3]
    assert nb == tuple(-(-dims // b) for b in brick[::-1])
    for o, (lo, hi) in enumerate(ht.HASH_RANGES):
        assert int(win[..., o, 0].min()) >= lo and int(win[..., o, 1].max()) <= hi
        assert int((win[..., o, 1] - win[..., o, 0] + 1).max()) <= caps[o]
    rng = np.random.default_rng(dims + int(10 * sin_t) + len(kernel))
    picks = [tuple((n - 1) * k for n, k in zip(nb, corner)) for corner in np.ndindex(2, 2, 2)]
    picks += [tuple(int(rng.integers(0, n)) for n in nb) for _ in range(8)]
    for index in picks:
        lo, hi = _brick_arguments(dims, torch.tensor(sin_t), brick, index, offsets)
        for o in range(3):
            assert win[index][o, 0] <= lo[o] and hi[o] <= win[index][o, 1], (index, o)


@pytest.mark.parametrize("dims", [16, 33, 96, 100, 256, 512])
def test_window_capacity_bounds_every_window(dims):
    """window_capacity bounds the windows of every brick at any sin t (here
    -1, 0, 1) for the kernels' bricks and a small one, and the bricks the
    wrapper launches fit the shared-memory limit."""
    for default, offsets in ((genvol.K8_BRICK, False), (genvol.K9_BRICK, True)):
        brick, caps = genvol._brick(default, dims, offsets)
        assert 4 * sum(caps) <= genvol._SMEM_LIMIT
        for b in (brick, (32, 3, 5)):
            caps = genvol.window_capacity(dims, b, offsets)
            for sin_t in (-1.0, 0.0, 1.0):
                w = genvol.brick_windows(dims, sin_t, b, offsets)
                length = (w[..., 1] - w[..., 0] + 1).amax(dim=(0, 1, 2))
                assert all(int(n) <= cap for n, cap in zip(length, caps)), (b, sin_t)


def test_brick_is_checked():
    """Too large a window cuts the brick, z first (at a small dims), never
    x; the kernels' bricks fit whole at the dims they run at; the launchers
    check dims and sin t before they build anything."""
    assert genvol._brick((32, 4, 64), 512, True)[0] == (32, 4, 64)
    assert genvol._brick((32, 32, 256), 33, False)[0] == (32, 32, 16)
    assert genvol._brick(genvol.K8_BRICK, 512, False)[0] == genvol.K8_BRICK
    assert genvol._brick(genvol.K9_BRICK, 256, True)[0] == genvol.K9_BRICK
    for launch, args in ((genvol.launch_density, (torch.zeros(()), 0)),
                         (genvol.launch_density, (torch.zeros(()), 8.0)),
                         (genvol.launch_xor, (torch.zeros(2), 8))):
        with pytest.raises(ValueError):
            launch(*args)


def test_one_table_for_the_field_kernels():
    """K7, K9 and K8 share hash_table.py's table: march_field re-exports it."""
    for name in ("HASH_RANGES", "HashTable", "build_hash_table", "hash_table", "table_hash"):
        assert getattr(mf, name) is getattr(ht, name)
    assert ht.hash_table("cpu") is mf.hash_table("cpu")
    args = ht.table_args(ht.hash_table("cpu"))
    assert len(args) == 10 and args[1:4] == tuple(lo for lo, _ in ht.HASH_RANGES)


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("launch", ["launch_density", "launch_xor"])
def test_cut_table_traps_on_gpu(cuda_device, launch):
    """A table that misses most of octave 0's lattice arguments makes the
    kernel trap; the stream's synchronization raises (in a process of its
    own: the CUDA context is lost)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from vokselis_torch.ops.cuda import genvol, hash_table as ht\n"
        "dev = torch.device('cuda', 0)\n"
        "(lo, _), *rest = ht.HASH_RANGES\n"
        "bad = ht.build_hash_table(dev, ((lo, lo + 300), *rest))\n"
        f"genvol.{launch}(torch.zeros((), device=dev), 64, table=bad)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError:\n"
        "    sys.exit(3)\n"
    )
    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, proc.stdout + proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("brick", [(32, 1, 1), (32, 4, 64), (32, 16, 8)])
def test_brick_never_changes_a_voxel_on_gpu(cuda_device, brick):
    """Other bricks give the same bits as the kernels' own (K9's threads
    allow y <= 8), and each launch counts once."""
    time = 0.9
    sin_t = torch.sin(torch.tensor(time, device=cuda_device) * 1.0)
    before = (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY)
    v = genvol.generate_density_u8(time, 100, cuda_device)
    assert torch.equal(v, genvol._launch(False, sin_t, 100, brick=brick))
    d, n = genvol.generate_xor_volumes(time, 96, cuda_device)
    d2, n2 = genvol._launch(True, sin_t, 96, brick=(32, min(brick[1], 8), brick[2]))
    assert torch.equal(d, d2) and torch.equal(n, n2)
    assert (genvol.LAUNCHES_GENVOL, genvol.LAUNCHES_DENSITY) == (before[0] + 2, before[1] + 2)
