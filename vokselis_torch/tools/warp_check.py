"""What ``chip_smoke.py`` needs to hold K6 and K5, the screen warps, on the
card: their inputs at the bench pose's fast geometry for a frame and an
intermediate, their errors against the plain versions, the texels their taps
touch (for the bounds), and the order of a kernel's global loads in its SASS.
Nothing here launches a kernel; the tests run it on the CPU.
"""

from __future__ import annotations

import re

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.ops import shear_warp
from vokselis_torch.ops.cuda import shear_resample as sr

# the flagship 1024^2, config 4's 1920x1080 (partial 32-pixel tiles), and a
# frame whose width and pixel count are not multiples of 4
FRAMES = ((1024, 1024), (1920, 1080), (1001, 563))
STATS_RTOL = 1e-5  # K5's sums: another summation order than torch.sum
# SASS opcodes without a destination register
NO_DEST = {"ST", "STG", "STS", "STL", "RED", "BRA", "EXIT", "BAR", "RET", "CALL", "MEMBAR",
           "NOP", "BSYNC", "BSSY", "WARPSYNC", "DEPBAR", "ERRBAR", "CCTL", "YIELD", "JMP"}


def warp_inputs(packs, width: int, height: int, ii: int):
    """K6's and K5's inputs at the bench pose (``Camera.bonsai`` at the
    frame's aspect), as the fast and hybrid frames build them: the slab
    stage's (4, ii, ii) planes, the warp coordinates and masks, and K5's
    r, g, b + curvature channels."""
    dev = packs[0].device
    geo = shear_warp.fast_geometry(packs, Camera.bonsai(width / height).uniform(dev), width,
                                   height, ii)
    planes = sr.resample_composite(packs[0], geo.m, geo.pos_u, geo.pos_v, geo.sgn, geo.irho,
                                   geo.occ_k, geo.occ_rb)
    av, bu, ok = shear_warp.warp_coords(geo, ii, ii)
    chans = torch.cat([planes[:3], shear_warp.curvature(planes)[None]])
    return {"planes": planes, "av": av, "bu": bu, "ok": ok, "box": geo.hit, "chans": chans}


def k5_args(inp):
    """K5's arguments from :func:`warp_inputs`."""
    return inp["chans"], inp["av"], inp["bu"], inp["ok"], inp["box"]


def k6_error(out, ref) -> dict:
    """K6 against its plain version: max |d|, the share of equal values and
    whether all are equal."""
    return {"max": float((out - ref).abs().max()),
            "bitwise": float((out == ref).double().mean()), "equal": torch.equal(out, ref)}


def k5_error(rgb, stats, rgb_p, stats_p) -> dict:
    """K5 against its plain version: rgb max |d| and equal share, whether
    the stats after STAT_EDGE (the overflow column, STAT_EXT and STAT_PEAK)
    are equal, the largest relative difference of STAT_CURV and STAT_EDGE
    and the tiles over STATS_RTOL; ``ok`` when all hold."""
    d = (stats - stats_p).abs()[:, :2]
    ref = stats_p[:, :2].abs()
    exact = torch.equal(stats[:, 2:], stats_p[:, 2:])
    over = int((d > STATS_RTOL * ref).sum())
    err = {"rgb_max": float((rgb - rgb_p).abs().max()),
           "rgb_bitwise": float((rgb == rgb_p).double().mean()), "ovf_ext_peak_equal": exact,
           "curv_edge_rel": float((d / ref.clamp(min=1e-30)).max()), "tiles_over": over}
    err["ok"] = torch.equal(rgb, rgb_p) and exact and over == 0
    return err


def tapped_texels(av, bu, mask, iv: int, iu: int) -> int:
    """The distinct texels of an (iv, iu) plane that the four bilinear taps
    of the pixels ``mask`` keeps touch (``warp_plain``'s clamped taps): what
    a warp must read of each channel for this frame."""
    a = torch.clamp(av[mask], 0.0, iv - 1.0)
    b = torch.clamp(bu[mask], 0.0, iu - 1.0)
    v0, u0 = torch.floor(a).long(), torch.floor(b).long()
    v1, u1 = (v0 + 1).clamp(max=iv - 1), (u0 + 1).clamp(max=iu - 1)
    seen = torch.zeros(iv * iu, dtype=torch.bool, device=av.device)
    for v in (v0, v1):
        for u in (u0, u1):
            seen[v * iu + u] = True
    return int(seen.sum())


def load_batches(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing, its global loads (LDG)
    in program order, grouped: a group ends at the first instruction that
    reads a register one of its loads wrote. ``[4, 48]`` means four loads
    in flight together, then 48 that waited for them and no more; a load
    behind a per-pixel chain shows as many small groups."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        groups, cur, pending = [], 0, set()
        for line in part.splitlines():
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?)\s*;", line)
            if not m:
                continue
            op, ops = m.group(1), [a.strip() for a in m.group(2).split(",")]
            base = op.split(".")[0]
            has_dest = base not in NO_DEST and bool(ops[0])
            read = {int(r) for a in (ops[1:] if has_dest else ops)
                    for r in re.findall(r"\bR(\d+)\b", a)}
            if pending & read:
                groups.append(cur)
                cur, pending = 0, set()
            dest = re.match(r"R(\d+)", ops[0]) if has_dest else None
            if base == "LDG" and dest:
                cur += 1
                width = 4 if ".128" in op else 2 if ".64" in op else 1
                pending |= set(range(int(dest.group(1)), int(dest.group(1)) + width))
            elif dest:
                pending.discard(int(dest.group(1)))
        if cur:
            groups.append(cur)
        out[name] = groups
    return out
