#!/usr/bin/env python3
"""How many of a call's kernel launches a torch.profiler trace sees on one
CUDA card, as the process ages, against the call's captured CUDA graph:

    python3 scripts/profiler_loss.py [--rounds N]

Two calls: config 6's second 2048^2 early-stopping CG solve (kmax 4, 24
launches of the six FFT-route kernels; chip_smoke.config6_unwrap_calls)
and a plane fit of a (3, 2048, 2048) stack (61 irls_step_kernel
launches). Each round traces each call once (the call 20 ms inside the
trace) and counts those launches, then reads them from the call's
captured graph (pygpa_tpu_torch.ops._build.graph_kernels), then
ages the process by ten more profiler sessions and 18 s of sleep. One
line a round: seconds since the start, the traced and the graph counts.
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced(fn, key):
    """Launches of fn() whose kernel name holds one of `key`, in one
    torch.profiler trace of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return sum(any(k in e.name for k in key) for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=14)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("profiler_loss: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pygpa_tpu_torch.ops import _build, cg, fit
    t0 = time.perf_counter()
    print(f"card {cs.card_line()}", flush=True)
    _build.load()
    a = cs.config6_unwrap_calls()[1]
    img = torch.randn(3, 2048, 2048, device="cuda") + 20

    def solve():
        return cg.cg_unwrap(*a[:5])

    def plane_fit():
        return fit.fit_plane_irls(img, None, 1.0, 60)

    solve()
    plane_fit()
    torch.cuda.synchronize()
    want = (6 * max(int(a[3]), 1), 61)
    for _ in range(args.rounds):
        row = {"cg traced": traced(solve, cs.UNWRAP_ITER_KERNELS),
               "fit traced": traced(plane_fit, ("irls_step_kernel",)),
               "cg graph": sum(any(k in n for k in cs.UNWRAP_ITER_KERNELS)
                               for n in _build.graph_kernels(solve)),
               "fit graph": sum("irls_step_kernel" in n
                                for n in _build.graph_kernels(plane_fit))}
        print(f"t={time.perf_counter() - t0:.0f} s, launches (cg, fit) "
              f"{want}: {row}", flush=True)
        for _ in range(10):
            traced(solve, ())
        time.sleep(18)
    return 0


if __name__ == "__main__":
    sys.exit(main())
