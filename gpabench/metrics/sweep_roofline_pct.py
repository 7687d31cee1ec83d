"""The grouped sweep's share of its bound, %: the least time the card
could take for the sweep's work at the call's shapes (its stage-1 and
stage-2 complex products at the dense TF32 peak, or its bytes at the HBM
peak: gpabench/harness/roofline.py) over the kernels' device time a call.
That time is each kernel's mean device time a launch in the trace, times
its launches a call as the program counts them (ops._build.launches:
"sweep_uv" counts one stage1, grouped_stage2 and uv launch each,
"split_basis" one split), never the sum of the events seen."""
from gpabench.harness import roofline, trace

KERNELS = {"stage1_kernel": "sweep_uv", "grouped_stage2_kernel": "sweep_uv",
           "uv_kernel": "sweep_uv", "split_basis_kernel": "split_basis"}


def read(run):
    if run.trace is None or run.plan is None:
        return None
    stats = trace.kernel_stats(run.trace[0])
    ms = 0.0
    for kernel, counter in KERNELS.items():
        per_call = run.launches.get(counter, 0.0)
        if per_call == 0:
            continue
        if kernel not in stats:
            return None
        ms += stats[kernel][1] * 1e3 * per_call
    if ms <= 0:
        return None
    G, P, H, W0, Wb = run.plan
    n, m = run.shape
    ops, nbytes = roofline.grouped_sweep_work(run.batch, G, P, H, n, m, W0,
                                              Wb)
    return 100.0 * roofline.tensor_core_bound_ms(ops, nbytes) / ms
