"""The cases of tests/test_torch_parallel.py, run by every rank of a gloo
world of WORLD processes on the CPU (torch and the port only, no JAX):
the rank's results go to a pickle that the test module compares with
pygpa_tpu and with the port's single-device functions.

run_rank(rank, store, inputs, out) is the spawned entry point: it joins
the world through the file store `store` (60 s timeout), loads the
inputs the test module wrote (`inputs`, an npz), runs every case of
CASES and pickles {case: ("ok", {name: numpy array}) or ("error",
traceback)} to `out`. A case that fails on one rank times out the
others' collectives, so a fault fails tests instead of hanging them.
"""
import datetime
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
TIMEOUT_S = 60


def _np(t):
    """A DTensor gathered, or a tensor, as numpy."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def case_mesh(inp):
    from pygpa_tpu_torch.parallel import batch_sharding, make_mesh
    mesh = make_mesh(WORLD, device_type="cpu")
    mesh2 = make_mesh(WORLD, ("batch", "k"), shape=(2, 2),
                      device_type="cpu")
    try:
        make_mesh(WORLD, ("batch", "k"), device_type="cpu")
        raised = 0
    except ValueError:
        raised = 1
    return {"shape": np.array(mesh.shape), "shape2": np.array(mesh2.shape),
            "multi_axis_raises": np.array(raised),
            "placements": np.array([repr(p) for p in batch_sharding(mesh)]),
            "placements2": np.array([repr(p) for p in
                                     batch_sharding(mesh2, "k")])}


def case_sweep(inp):
    from pygpa_tpu_torch.parallel import make_mesh, wfr_sweep_sharded
    mesh = make_mesh(device_type="cpu")
    out = wfr_sweep_sharded(torch.from_numpy(inp["img96"]), inp["wlist96"],
                            inp["ks96"][0], 8, mesh, with_grad=True)
    return {k: _np(v) for k, v in out.items()}


def case_tie(inp):
    from pygpa_tpu_torch.parallel import make_mesh, wfr_sweep_sharded
    mesh = make_mesh(device_type="cpu")
    wl = np.tile(inp["ks96"][0][None, :], (16, 1))
    out = wfr_sweep_sharded(torch.from_numpy(inp["img96"]), wl,
                            inp["ks96"][0], 8, mesh)
    return {k: _np(v) for k, v in out.items()}


def case_batch(inp):
    from pygpa_tpu_torch.parallel import (extract_displacement_field_batch,
                                          make_mesh)
    mesh = make_mesh(device_type="cpu")
    u = extract_displacement_field_batch(inp["batch96"], inp["ks96"],
                                         mesh=mesh, device="cpu")
    return {"u": _np(u), "placements": np.array([repr(p) for p in
                                                 u.placements])}


def case_fft(inp):
    from pygpa_tpu_torch.parallel import (fft2_sharded, ifft2_sharded,
                                          make_mesh)
    mesh = make_mesh(device_type="cpu")
    f = fft2_sharded(torch.from_numpy(inp["rand128x256"]), mesh)
    back = ifft2_sharded(f, mesh)
    try:
        fft2_sharded(torch.zeros(130, 256, dtype=torch.float64), mesh)
        raised = 0
    except ValueError:
        raised = 1
    return {"fft": _np(f), "back": _np(back), "odd_raises": np.array(raised)}


def case_spatial(inp):
    from pygpa_tpu_torch.parallel import make_mesh, wfr_sweep_spatial
    mesh = make_mesh(device_type="cpu")
    out = wfr_sweep_spatial(torch.from_numpy(inp["img128"]),
                            inp["wlist128"], inp["ks128"][0], 8, mesh)
    return {k: _np(v) for k, v in out.items()}


def case_mesh2d(inp):
    from pygpa_tpu_torch.parallel import (extract_displacement_field_batch,
                                          make_mesh, wfr_sweep_sharded)
    mesh = make_mesh(WORLD, ("batch", "k"), shape=(2, 2), device_type="cpu")
    res = {}
    for b, im in enumerate(inp["batch2d"]):
        out = wfr_sweep_sharded(torch.from_numpy(im), inp["wlist96"],
                                inp["ks96"][0], 8, mesh, axis="k")
        res[f"lockin{b}"] = _np(out["lockin"])
    u = extract_displacement_field_batch(inp["batch2d"], inp["ks96"],
                                         mesh=mesh, device="cpu")
    res["u"] = _np(u)
    return res


def case_dct(inp):
    from pygpa_tpu_torch.parallel import (dct2n_sharded, idct2n_sharded,
                                          make_mesh)
    mesh = make_mesh(device_type="cpu")
    y = dct2n_sharded(torch.from_numpy(inp["rand64x128"]), mesh)
    return {"dct": _np(y), "back": _np(idct2n_sharded(y, mesh))}


def case_unwrap(inp):
    from pygpa_tpu_torch.parallel import (make_mesh,
                                          phase_unwrap_prediff_sharded)
    mesh = make_mesh(device_type="cpu")
    args = (torch.from_numpy(inp["dx64"]), torch.from_numpy(inp["dy64"]),
            torch.from_numpy(inp["w64"]))
    return {"cg": _np(phase_unwrap_prediff_sharded(*args, mesh, kmax=30)),
            "mg": _np(phase_unwrap_prediff_sharded(*args, mesh, kmax=30,
                                                   coarse=4))}


def case_reconstruct(inp):
    from pygpa_tpu_torch.parallel import (
        make_mesh, reconstruct_u_inv_from_demod_sharded)
    mesh = make_mesh(device_type="cpu")
    res = {}
    for coarse in (None, 4):
        u = reconstruct_u_inv_from_demod_sharded(
            inp["ks128"], torch.from_numpy(inp["ph128"]),
            torch.from_numpy(inp["wt128"]), mesh, unwrap_coarse=coarse)
        res[f"u{coarse}"] = _np(u)
    return res


def case_pipeline(inp):
    from pygpa_tpu_torch.parallel import (extract_displacement_field_sharded,
                                          make_mesh)
    mesh = make_mesh(device_type="cpu")
    res = {}
    for coarse in (None, 4):
        u = extract_displacement_field_sharded(
            torch.from_numpy(inp["img128"]), inp["ks128"], mesh,
            unwrap_coarse=coarse)
        res[f"u{coarse}"] = _np(u)
        res["placements"] = np.array([repr(p) for p in u.placements])
    return res


def case_no_full_plane(inp):
    """The row-sharded pipeline and unwrap on DTensor inputs under a
    dispatch mode recording every plain tensor an op creates whose last
    two axes are a global plane: the names of those ops."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._python_dispatch import TorchDispatchMode
    from pygpa_tpu_torch.parallel import (extract_displacement_field_sharded,
                                          make_mesh,
                                          phase_unwrap_prediff_sharded)
    mesh = make_mesh(device_type="cpu")
    rank = dist.get_rank()

    def shard(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        r = a.shape[-2] // WORLD
        return DTensor.from_local(a[..., rank * r:(rank + 1) * r, :]
                                  .contiguous(), mesh,
                                  [Shard(a.dim() - 2)], run_check=False)

    def aligned(dx, dy):
        dx = np.concatenate([dx, np.zeros_like(dx[:, :1])], axis=1)
        dy = np.concatenate([dy, np.zeros_like(dy[:1])], axis=0)
        return dx, dy

    class Planes(TorchDispatchMode):
        def __init__(self, planes):
            super().__init__()
            self.planes, self.seen, self.ops = planes, [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if type(t) is torch.Tensor:
                    self.ops += 1
                    if tuple(logical(func, args, t)[-2:]) in self.planes:
                        self.seen.append(str(func))
            return out

    def logical(func, args, t):
        """The shape of t as the program sees it: a batched product
        (..., r, k) @ (k, m) runs as one 2-D mm on its rows folded
        together, whose output is logically (..., r, m)."""
        a = args[0] if args else None
        if func is torch.ops.aten.mm.default and a._base is not None \
                and a._base.dim() > 2 and a._base.shape[-1] == a.shape[-1] \
                and a._base.numel() == a.numel():
            return tuple(a._base.shape[:-1]) + (t.shape[-1],)
        return tuple(t.shape)

    img = shard(inp["img128"])
    dx, dy = aligned(inp["dx64"], inp["dy64"])
    args = (shard(dx), shard(dy), shard(inp["w64"]))
    res = {}
    with Planes({(128, 128)}) as mode:
        u = extract_displacement_field_sharded(img, inp["ks128"], mesh,
                                               unwrap_coarse=4)
    res["pipeline_seen"] = np.array(mode.seen, dtype=object)
    res["pipeline_ops"] = np.array(mode.ops)
    res["pipeline_u"] = _np(u)
    for coarse in (None, 4):
        with Planes({(64, 64)}) as mode:
            phi = phase_unwrap_prediff_sharded(*args, mesh, kmax=30,
                                               coarse=coarse)
        res[f"unwrap{coarse}_seen"] = np.array(mode.seen, dtype=object)
        res[f"unwrap{coarse}_ops"] = np.array(mode.ops)
        res[f"unwrap{coarse}"] = _np(phi)
    return res


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def run_rank(rank, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    inp = dict(np.load(inputs))
    results = {}
    try:
        for name, fn in CASES.items():
            try:
                results[name] = ("ok", fn(inp))
            except Exception:      # reported per case by the test module
                results[name] = ("error", traceback.format_exc())
    finally:
        with open(out, "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
