"""The hybrid's error against its re-march budget, from one fast frame and
one exact frame per pose (the port of ``tools/residual_decay.py``): a
re-marched tile becomes exact, so err(B) = total - (the B selected tiles'
error), under

- ORACLE selection: the tiles in order of their true error, the floor for
  any ranking of tiles;
- ACTUAL selection: the hybrid's own picks, :func:`vokselis_torch.ops.
  hybrid.select_units` of :func:`~vokselis_torch.ops.hybrid.score_tiles` over
  the same pose's ``"stats"`` frame (K5's tile statistics), single tiles,
  parked at ``DEFAULT_THRESH``.

The gap between the curves is the selection's quality; the oracle curve's
tail is the diffuse error no budget removes. With the per-tile price from
:mod:`vokselis_torch.tools.fit_budget_slope`, the curve says what error a
budget's milliseconds buy.

    python -m vokselis_torch.tools.residual_decay [--ii 512] [--budgets 0,16,...] [--out-dir DIR]

Writes ``<out-dir>/decay_raw_<pose>_<ii>.npz`` (the arrays that
``tools/score_lab.py`` reads from ``/tmp/r3_logs``: give ``--out-dir
/tmp/r3_logs`` to iterate scores there) and ``<out-dir>/residual_decay_<ii>.json``.
Runs on the card; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.core.colors import linear_to_srgb
from vokselis_torch.ops.cuda.march_bonsai import build_renderer
from vokselis_torch.ops.hybrid import DEFAULT_THRESH, score_tiles, select_units
from vokselis_torch.ops.shear_warp import _render_fast, pose_hint, prepare_fast_volume
from vokselis_torch.tools.common import DEFAULT_OUT_DIR, add_device_arg, card_of, device_of
from vokselis_torch.utils.grid import TILE
from vokselis_torch.volume.io import get_bonsai

SIZE = 1024
DEFAULT_BUDGETS = (0, 16, 32, 48, 64, 96, 128, 192, 256, 384)


def decay_poses() -> dict:
    """The four poses of tools/residual_decay.py:59-66."""
    c = dict(target=(0.5, 0.5, 0.5), aspect=1.0)
    return {
        "bench": Camera.bonsai(1.0),
        "z1.0-axis": Camera(zoom=1.0, pitch=0.0, yaw=0.0, **c),
        "z1.6-diag": Camera(zoom=1.6, pitch=0.5, yaw=math.pi / 4, **c),
        "z1.0-tilt": Camera(zoom=1.0, pitch=-0.35, yaw=0.0, **c),
    }


def tile_mean(x):
    """Per 32x32 tile means of an (H, W) array, raster order (H and W whole
    tiles)."""
    ny, nx = x.shape[0] // TILE, x.shape[1] // TILE
    return x.reshape(ny, TILE, nx, TILE).mean(axis=(1, 3)).reshape(-1)


def decay_pose(packs, render, pack, u, size: int, ii: int, budgets):
    """One pose: ``(record, dump, picks)``. ``record`` is the JSON's
    (total fast error, degeneracy, the curve); ``dump`` the arrays of
    ``decay_raw_*.npz``; ``picks`` the actual selection's tile ids at each
    budget (sorted numpy int arrays)."""
    degen = pose_hint(u, size, size, ii, int(pack.shape[0]))[2]
    exact = render(pack, u, size, size)[..., :3].cpu().numpy()
    img, bad, errd = _render_fast(packs, u, size, size, ii, False, return_aux=True)
    # sRGB like the final frame: the error budget is measured in sRGB
    fast_s = linear_to_srgb(torch.clamp(img[..., :3], min=0.0)).cpu().numpy()
    rgb = img[..., :3].cpu().numpy()
    bad = bad.cpu().numpy()
    errd = errd.cpu().numpy()
    _, stats = _render_fast(packs, u, size, size, ii, False, return_aux="stats")
    ny = nx = size // TILE
    n_tiles = ny * nx
    scores = score_tiles(stats, ny, nx)

    err_px = np.abs(fast_s - exact).mean(axis=-1)
    per_tile_err = tile_mean(err_px)  # the mean per-pixel error a tile owns
    total = per_tile_err.mean()
    order_oracle = np.argsort(per_tile_err)[::-1]
    rec = {"total_fast_err": round(float(total), 9), "degen": bool(degen), "curve": []}
    picks = {}
    for b in budgets:
        ids = select_units(scores, n_tiles, b, DEFAULT_THRESH, pair=False)
        sel_a = np.sort(ids[ids < n_tiles].cpu().numpy().astype(np.int64))
        picks[b] = sel_a
        top = per_tile_err[order_oracle[:b]]
        # the picks' errors summed as the oracle's are, largest first and
        # zero-padded to its length: elementwise no larger, so no larger a sum
        mine = np.zeros_like(top)
        mine[:len(sel_a)] = np.sort(per_tile_err[sel_a])[::-1]
        e_o = total - top.sum() / n_tiles
        e_a = total - mine.sum() / n_tiles
        rec["curve"].append({"budget": b, "oracle": round(float(e_o), 9),
                             "actual": round(float(e_a), 9)})
    dump = {"per_tile_err": per_tile_err, "errd": errd.astype(np.float32),
            "bad": bad.astype(np.uint8), "rgb": rgb.astype(np.float32),
            "fast_srgb": fast_s.astype(np.float32), "err_px": err_px.astype(np.float32)}
    return rec, dump, picks


def run(device, ii: int, budgets, size: int = SIZE, vol=None, poses=None,
        out_dir: str = DEFAULT_OUT_DIR, log=print) -> dict:
    """Every pose's record, each pose's dump written under ``out_dir``, and
    the records as ``residual_decay_<ii>.json`` there."""
    device = torch.device(device)
    vol = get_bonsai() if vol is None else vol
    all_poses = decay_poses()
    poses = list(all_poses) if poses is None else poses
    render, pack = build_renderer(vol, device)
    packs = prepare_fast_volume(vol, device)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name in poses:
        rec, dump, _ = decay_pose(packs, render, pack, all_poses[name].uniform(device), size,
                                  ii, budgets)
        # the raw per-pose arrays, for scoring offline in numpy (tools/score_lab.py)
        np.savez_compressed(os.path.join(out_dir, f"decay_raw_{name}_{ii}.npz"), **dump)
        out[name] = rec
        log(name, json.dumps(rec))
    path = os.path.join(out_dir, f"residual_decay_{ii}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log("wrote", path)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_arg(parser)
    parser.add_argument("--ii", type=int, default=512, help="the fast frame's intermediate I")
    parser.add_argument("--budgets", default=",".join(map(str, DEFAULT_BUDGETS)),
                        help="budgets (tiles), comma-separated")
    parser.add_argument("--poses", default=",".join(decay_poses()),
                        help="poses, comma-separated, of " + ", ".join(decay_poses()))
    parser.add_argument("--size", type=int, default=SIZE,
                        help="frame side, pixels (whole 32-pixel tiles)")
    parser.add_argument("--dims", type=int, default=256, help="the bonsai volume's side")
    parser.add_argument("--out-dir", default=DEFAULT_OUT_DIR, help="the dumps and the JSON")
    args = parser.parse_args(argv)
    device = device_of(parser, args)
    poses = args.poses.split(",")
    if set(poses) - set(decay_poses()) or args.size % TILE:
        parser.error(f"--poses of {list(decay_poses())}, --size a multiple of {TILE}")
    print(f"device: {card_of(device)}", flush=True)
    run(device, args.ii, [int(b) for b in args.budgets.split(",")], args.size,
        get_bonsai(args.dims), poses, args.out_dir, log=lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
