"""What decides `correct`: the outputs of sampled timed calls, compared
with the plain reference (gpabench/reference, float64) once the window
has closed, each number against its limit in gpabench/limits/<cell>.json.

Where a stage's reference takes an earlier stage's output (the quick
start's field from the program's refined ks, the undistortion and the
unit cell from the program's u, the properties from the program's u),
that earlier output is itself compared on its own. The control is the
reference computed with bfloat16 storage put in the program's place,
judged by the same functions (gpabench/readings.py).
"""
import math

import numpy as np
import torch

from ..reference import gpa as rgpa
from ..reference import multigrid
from ..reference import props as rprops
from ..reference import quickstart as rqs
from ..reference.precision import Store

F64 = torch.float64


def p99(x):
    x = x.reshape(-1)
    k = max(1, int(math.ceil(0.99 * x.numel())))
    return float(torch.kthvalue(x.cpu(), k).values)


def u_gaps(u, u_ref, border):
    """(p99, max) over the interior of |u - u_ref| less its mean, px (u is
    defined up to a constant)."""
    d = (torch.as_tensor(u).to(u_ref.device, F64) - u_ref)
    d = d[..., border:-border, border:-border]
    d = (d - d.mean(dim=(-2, -1), keepdim=True)).abs()
    return p99(d), float(d.max())


def worst(acc, numbers):
    """acc updated with the larger of each number."""
    for k, v in numbers.items():
        acc[k] = max(acc.get(k, v), v)
    return acc


# ------------------------------------------------------------- factory

def factory_reference(img, ks, device, coarse, store=Store()):
    """The reference's u (2, n, m) of a factory call's image: the
    multigrid's integral where the factory takes it (unwrap_coarse),
    the least-squares integral otherwise."""
    integrate = None
    if coarse:
        def integrate(dx, dy, wn):
            return multigrid.integrate(dx, dy, wn, coarse=int(coarse))
    return rgpa.displacement(torch.as_tensor(img).to(device), ks,
                             rgpa.factory_banks(ks), store=store,
                             integrate=integrate)


def judge_factory(images, us, ks, device, border, coarse):
    """{"u_p99_px", "u_max_px"} of a call's images (B, n, m) and fields
    (B, 2, n, m), the largest over the images."""
    out = {}
    for img, u in zip(images, us):
        ref = factory_reference(img, ks, device, coarse)
        p, mx = u_gaps(u, ref, border)
        worst(out, {"u_p99_px": p, "u_max_px": mx})
        del ref
    return out


def judge_mosaic(path, origins, tile, tiles, us, props, ks, device, border,
                 coarse):
    """{"tile_max_rel", "u_p99_px", "u_max_px", "twist_p99_deg",
    "twist_max_deg", "kappa_p99", "kappa_max"} of a call's tiles as read
    (B, t, t), fields (B, 2, t, t) and properties (B, 4, t, t): the tiles
    against the file read by the reference, the fields against the
    reference's from its own tiles, the properties on the interior
    against the reference's from the program's fields."""
    out = {}
    b = border
    for j, o in enumerate(origins):
        ref_tile = rprops.tile(path, o, tile)
        got = np.asarray(tiles[j], np.float64)
        worst(out, {"tile_max_rel": float(np.abs(got - ref_tile).max()
                                          / np.abs(ref_tile).max())})
        ref_u = factory_reference(torch.as_tensor(ref_tile), ks, device,
                                  coarse)
        p, mx = u_gaps(us[j], ref_u, b)
        worst(out, {"u_p99_px": p, "u_max_px": mx})
        del ref_u
        twist, _, kappa = rprops.props(torch.as_tensor(us[j]).to(device))
        pj = torch.as_tensor(props[j]).to(device, F64)
        dt = (pj[0] - twist)[b:-b, b:-b].abs()
        dk = (pj[3] - kappa)[b:-b, b:-b].abs()
        worst(out, {"twist_p99_deg": p99(dt), "twist_max_deg": float(dt.max()),
                    "kappa_p99": p99(dk), "kappa_max": float(dk.max())})
    return out


# ---------------------------------------------------------- quick start

def quickstart_reference_ks(img):
    """The reference's found ks (DoG) and refined ks of an image."""
    found = rqs.primary_ks(img, dog=True)
    pks = rqs.primary_ks(img, dog=False, subpixel=True)
    return found, rqs.refine_ks(img, pks)


def quickstart_outputs(img, z, store):
    """The quick start's outputs computed by the reference with `store`
    (the control, with bfloat16 storage)."""
    found = rqs.primary_ks(img, dog=True, store=store)
    pks = rqs.primary_ks(img, dog=False, subpixel=True, store=store)
    ks = rqs.refine_ks(img, pks, store=store)
    u = rgpa.displacement(img, ks, rgpa.eager_banks(ks), store=store)
    flat = rqs.undistort(img, u, store=store)
    cell, _ = rqs.unit_cell(img, ks[:2], u, z, store=store)
    return {"ks_found": found, "ks": ks, "u": u, "flat": flat, "cell": cell}


def judge_quickstart(img, out, z, device):
    """{"ks_found_bins", "k_refined_bins", "u_p99_px", "u_max_px",
    "flat_max_rel", "cell_max_rel"} of one quick start call's outputs on img (n, m): the
    found ks in whole bins, the refined ks in bins, u on the 4 sigma
    interior, the undistorted image inside max |u| + 16 px of the border
    and the cell on bins of at least half the median weight (a bin's
    average moves by a pixel's noise over its count when a pixel at the
    cell's wrap falls on the other side by rounding), the last two over
    the image's standard deviation."""
    img = torch.as_tensor(img).to(device, F64)
    n = img.shape[-1]
    found, refined = quickstart_reference_ks(img)
    res = {}
    _, d = rqs.match(out["ks_found"], found)
    res["ks_found_bins"] = float(np.rint(d * n).max())
    _, d = rqs.match(out["ks"], refined)
    res["k_refined_bins"] = float(d.max() * n)
    ks = np.asarray(out["ks"], np.float64)
    u = torch.as_tensor(out["u"]).to(device, F64)
    ref_u = rgpa.displacement(img, ks, rgpa.eager_banks(ks))
    res["u_p99_px"], res["u_max_px"] = u_gaps(u, ref_u,
                                              4 * rgpa.default_sigma(ks))
    del ref_u
    scale = float(img.std())
    mg = int(math.ceil(float(u.abs().max()))) + 16
    ref_flat = rqs.undistort(img, u)
    flat = torch.as_tensor(out["flat"]).to(device, F64)
    res["flat_max_rel"] = float((flat - ref_flat)[mg:-mg, mg:-mg].abs()
                                .max()) / scale
    del ref_flat, flat
    ref_cell, w = rqs.unit_cell(img, ks[:2], u, z)
    cell = torch.as_tensor(out["cell"]).to(device, F64)
    if cell.shape != ref_cell.shape:
        res["cell_max_rel"] = math.inf
    else:
        d = (cell - ref_cell)[w >= 0.5 * w.median()].abs()
        res["cell_max_rel"] = float(d.max()) / scale
        res["cell_p99_rel"] = p99(d) / scale
    return res


def verdict(numbers, limits):
    """(correct, lines): every number that has a limit at or under it;
    one line a number, (name, value, limit, within)."""
    ok, lines = True, []
    for name, spec in limits.items():
        v = numbers.get(name, math.inf)
        lim = float(spec["limit"])
        good = v <= lim
        ok &= good
        lines.append((name, v, lim, good))
    return ok, lines
