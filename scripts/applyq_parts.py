#!/usr/bin/env python3
"""The V-branch applyq kernel's launch bounds and strip heights, and what
it does to the bench extractor, on one CUDA card:

    python3 scripts/applyq_parts.py bounds
    python3 scripts/applyq_parts.py path [--root DIR]

`bounds` compiles copies of csrc/vcycle.cu whose applyq launch bounds
allow 4, 6 and 8 blocks an SM (nvcc, as ops/_build.py does, one process
each, side by side), prints ptxas's registers and spills of every
applyq instance, and runs each copy at several strip heights on the
inputs of phase 4 (2, 4096^2) and 7a (one 2048^2 plane) of chip_smoke.py
(random p, a weight with a 1e-6 rim): the output must be applyq_plain's
bits, and each (copy, rows) is timed with CUDA events over 50 launches
after a warm-up, three times in alternating order.

`path` runs the bench extractor of chip_smoke.py phase 4 (4096^2,
`unwrap_coarse=4`) from the checkout --root names (default: the one
holding this script; for instance an unpacked `git archive` of another
commit, so that two commits are compared on one card, one process
each): host-clock seconds over 30 synchronized calls after 3 warm-up
calls, and torch.profiler's device time a call over 5 calls, all
kernels and the applyq kernel alone.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = "constexpr int QMIN_BLOCKS = 4;"


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def build(tmp, blocks):
    """Compile csrc/vcycle.cu with the applyq launch bounds set to
    `blocks` an SM, side by side; return {blocks: (library, ptxas lines
    of the applyq instances)}."""
    from pygpa_tpu_torch.ops import _build
    src = open(os.path.join(_build.SRC_DIR, "vcycle.cu")).read()
    if BLOCKS not in src:
        raise RuntimeError(f"csrc/vcycle.cu has no '{BLOCKS}'")
    procs = {}
    for b in blocks:
        cu = os.path.join(tmp, f"vcycle_b{b}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(BLOCKS, f"constexpr int QMIN_BLOCKS = {b};"))
        so = os.path.join(tmp, f"vcycle_b{b}.so")
        procs[b] = (so, subprocess.Popen(
            [_build.find_nvcc()] + _build.NVCC_FLAGS + ["-shared", "-o", so,
                                                        cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for b, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        lines, on = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                on = "applyq_strip_kernel" in line
                if on:
                    lines.append(line.split("'")[1])
            elif on and ("spill" in line or "Used" in line):
                lines.append(line.strip())
        fn = ctypes.CDLL(so).vcycle_applyq
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        out[b] = (fn, lines)
    return out


def cuda_ms(fn, reps=50):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bounds():
    import torch
    from pygpa_tpu_torch.ops import vcycle as vc
    print(card())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, (4, 6, 8))
        for b, (_, lines) in libs.items():
            print(f"{b} blocks an SM: ptxas " + " | ".join(lines))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        g = np.random.default_rng(0)
        for B, n in ((2, 4096), (1, 2048)):
            p = torch.from_numpy(g.normal(size=(B, n, n)).astype(
                np.float32)).cuda()
            w = g.uniform(0.05, 1.0, size=(n, n))
            w[:8] = w[-8:] = w[:, :8] = w[:, -8:] = 1e-6
            w = torch.from_numpy(w.astype(np.float32)).cuda()
            want = vc.applyq_plain(p, w)
            q = torch.empty_like(p)
            stream = torch.cuda.current_stream().cuda_stream
            cfgs = []
            for b in libs:
                tiles = -(-n // vc.APPLYQ_COLS)
                strips = max(1, sms * b * vc.APPLYQ_WARPS // tiles)
                one_wave = max(vc.APPLYQ_MIN_ROWS, -(-n // strips))
                cfgs += [(b, r) for r in sorted({one_wave, 16, 32, 64, 128})]

            def run(b, rows):
                rc = libs[b][0](p.data_ptr(), w.data_ptr(), q.data_ptr(), B,
                                n, n, rows, stream)
                if rc:
                    raise RuntimeError(f"vcycle_applyq returned {rc}")
            ms = {c: [] for c in cfgs}
            for c in cfgs:
                run(*c)
                torch.cuda.synchronize()
                if not torch.equal(q, want):
                    raise RuntimeError(f"{c}: not applyq_plain's bits")
            for rep in range(3):
                for c in (cfgs if rep % 2 == 0 else cfgs[::-1]):
                    ms[c].append(cuda_ms(lambda c=c: run(*c)))
            bound = (2 * B + 1) * n * n * 4 / 3.35e12 * 1e3
            print(f"({B}, {n}, {n}): bound {bound!r} ms; every copy and "
                  "strip height gives applyq_plain's bits")
            for (b, rows), t in ms.items():
                print(f"  {b} blocks an SM, {rows} rows a strip: ms {t!r}, "
                      f"median {sorted(t)[1]!r}")
            del p, w, want, q
            torch.cuda.empty_cache()


def path(root):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, root)
    import chip_smoke
    from pygpa_tpu_torch.gpa import pipeline
    ks, img, _, _ = chip_smoke.fixtures(torch)
    fn = pipeline.make_displacement_extractor(
        (chip_smoke.SIZE, chip_smoke.SIZE), ks, chunk=4, unwrap_coarse=4,
        device="cuda")
    for _ in range(3):
        fn(img)
    torch.cuda.synchronize()
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        fn(img)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn(img)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 5e3
    # the applyq kernel, not the CG's p_applyq_kernel or applyq_pq_kernel
    aq = sum(e.time_range.elapsed_us() for e in ev if "applyq" in e.name
             and "p_applyq" not in e.name and "applyq_pq" not in e.name) / 5e3
    print(f"{root} ({card()}): host s a call median {float(np.median(ts))!r}"
          f" min {min(ts)!r} max {max(ts)!r}; device ms a call {busy!r}, "
          f"applyq {aq!r}; card (SM clock, temperature, power draw) "
          f"{chip_smoke.card_state()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("bounds", "path"))
    ap.add_argument("--root", default=HERE)
    a = ap.parse_args()
    if a.part == "bounds":
        sys.path.insert(0, HERE)
        bounds()
    else:
        path(os.path.abspath(a.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
