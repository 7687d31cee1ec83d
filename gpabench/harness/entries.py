"""The program's entry points as a configuration names them, each built
once at set-up and called by the window on one input.

- "factory": make_displacement_extractor(shape, ks, **args)'s run on an
  image (n, m) or a stack (B, n, m), and, where the traffic asks for it,
  props.props_from_u on each image's field.
- "quickstart": the port's README quick start on one raw image:
  extract_primary_ks twice (DoG, then sub-bin), select_closest_to_triangle,
  refine_ks, extract_displacement_field, undistort_image,
  unit_cell_average.

A call takes `stages`, a list, in a traced run: it appends the call's
(stage, CUDA event) stamps for the per-layer metrics (None records
nothing), and `traced` labels its host phases in the trace."""
import numpy as np
import torch

from . import inputs
from .trace import phase


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Factory:
    def __init__(self, cfg, traffic, device):
        import pygpa_tpu_torch as gt
        self.gt = gt
        self.ks = inputs.primary_ks(cfg["lattice"], cfg["entry"]["peaks"])
        a = cfg["entry"]["args"]
        self.coarse = a.get("unwrap_coarse")
        self.run = gt.gpa.pipeline.make_displacement_extractor(
            tuple(cfg["shape"]), self.ks, device=device, **a)
        self.props = bool(traffic.get("props", False))

    def plan_shape(self):
        """(G, P, H, W0, Wb) of the grouped sweep's plan."""
        p = self.run.plan
        G, P, _ = p.wl.shape
        if p.col_groups is not None:
            Wb, runs = p.col_groups
            H = max(len(r) for r in runs)
        else:
            Wb, H = p.idx1s.shape[1], 1
        return int(G), int(P), int(H), int(p.idx0s.shape[1]), int(Wb)

    def __call__(self, x, stages=None, traced=False):
        ev = None
        if stages is not None:
            ev = [("start", _event())]
        with phase("run", traced):
            u = self.run(x, events=ev)
        out = {"u": u}
        if self.props:
            with phase("props", traced):
                us = u if u.dim() == 4 else u[None]
                out["props"] = torch.stack([
                    self.gt.props.props_from_u(ui, 1.0) for ui in us])
            if ev is not None:
                ev.append(("props", _event()))
        if stages is not None:
            stages.append(ev)
        return out


class QuickStart:
    def __init__(self, cfg, traffic, device):
        import pygpa_tpu_torch as gt
        self.gt = gt
        self.z = int(cfg["entry"]["ucell_z"])
        # the README's calls take the card by default; elsewhere (the
        # CPU tests) the device is named
        self.on = {} if device == "cuda" else {"device": device}

    def __call__(self, img, stages=None, traced=False):
        gt = self.gt
        ev = [("start", _event())] if stages is not None else None
        with phase("peaks", traced):
            ks_found, _ = gt.gpa.extract_primary_ks(img, **self.on)
            pks, _ = gt.gpa.extract_primary_ks(img, DoG=False, subpixel=True,
                                               **self.on)
            pks = gt.gpa.peaks.select_closest_to_triangle(pks)
        if ev is not None:
            ev.append(("peaks", _event()))
        with phase("refine", traced):
            ks = gt.gpa.refine_ks(img, pks, **self.on)
        if ev is not None:
            ev.append(("refine", _event()))
        with phase("extract", traced):
            u = gt.gpa.extract_displacement_field(img, ks, events=ev,
                                                  **self.on)
        with phase("undistort", traced):
            flat = gt.gpa.undistort_image(img, u, **self.on)
        if ev is not None:
            ev.append(("undistort", _event()))
        with phase("ucell", traced):
            cell = gt.ucell.unit_cell_average(img, ks[:2], u=u, z=self.z,
                                              **self.on)
        if ev is not None:
            ev.append(("ucell", _event()))
            stages.append(ev)
        return {"ks_found": np.asarray(ks_found), "pks": np.asarray(pks),
                "ks": np.asarray(ks), "u": u, "flat": flat, "cell": cell}


ENTRIES = {"factory": Factory, "quickstart": QuickStart}


def make(cfg, traffic, device):
    kind = cfg["entry"]["kind"]
    if kind not in ENTRIES:
        raise KeyError(f"unknown entry kind {kind!r}")
    return ENTRIES[kind](cfg, traffic, device)


def stage_ms(ev):
    """{stage: ms} of one call's (name, event) list: each stamp's time
    since the one before it (stamps of one name summed)."""
    out = {}
    for (_, a), (name, b) in zip(ev, ev[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out
