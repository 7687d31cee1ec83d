"""The traced part of a run: a torch.profiler trace of the device and of
the harness's own host phases (record_function labels "gpabench.<phase>"),
reduced to device intervals, kernel times by name and host phases.

A trace of a long-lived process can lose a prefix of its device events,
so nothing here sums events over the window: the device's span runs from
the trace's first device record to its last, and a kernel's time per call
is its mean time per launch seen times its launches counted by the
program."""
import re
from contextlib import contextmanager, nullcontext

PHASE = "gpabench."


def phase(name, on):
    """A host phase label in the trace (a no-op when untraced)."""
    if not on:
        return nullcontext()
    import torch
    return torch.profiler.record_function(PHASE + name)


@contextmanager
def profiled():
    """A torch.profiler session of the CPU and the CUDA device; yields a
    holder whose .events is filled on exit."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Trace", (), {})()
    holder.events = None
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield holder
    finally:
        prof.__exit__(None, None, None)
        holder.events = device_and_phases(prof)


def kernel_base(name):
    """A kernel's base name: "void ns::foo_kernel<1>(float*)" -> "foo_kernel"."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    s = re.split(r"[<(]", s)[0].strip()
    return s.split("::")[-1] or name


def device_and_phases(prof):
    """(device records [(name, start_ns, end_ns)], host phases [(label,
    start_ns, end_ns)]) of a finished profiler session."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.name().startswith(PHASE):
            # the labels are mirrored onto the device's timeline too
            if e.device_type() != DeviceType.CUDA:
                host.append((e.name()[len(PHASE):], start, end))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), start, end))
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def busy_intervals(dev):
    """The union of the device records' intervals, merged, in order."""
    out = []
    for _, s, e in dev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_span(dev):
    """(busy seconds, span seconds) over the trace's device records."""
    iv = busy_intervals(dev)
    if not iv:
        return 0.0, 0.0
    return (sum(e - s for s, e in iv) / 1e9, (iv[-1][1] - iv[0][0]) / 1e9)


def kernel_stats(dev):
    """{kernel base name: (launches seen, mean seconds a launch)}."""
    acc = {}
    for name, s, e in dev:
        k = kernel_base(name)
        c, t = acc.get(k, (0, 0.0))
        acc[k] = (c + 1, t + (e - s) / 1e9)
    return {k: (c, t / c) for k, (c, t) in acc.items()}


def top_device_ops(dev, count=10):
    """The device operations that took most time: [[name, seconds]]."""
    tot = {}
    for name, s, e in dev:
        k = kernel_base(name)
        tot[k] = tot.get(k, 0.0) + (e - s) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:count]]


def idle_gaps(dev, host, count=10):
    """The device's idle time inside its span, by the innermost host
    phase active in the middle of each gap ("other" outside any):
    [[phase, seconds]], longest first."""
    iv = busy_intervals(dev)
    tot = {}
    j = 0
    for (_, e0), (s1, _) in zip(iv, iv[1:]):
        mid = (e0 + s1) / 2
        label = "other"
        while j < len(host) and host[j][2] < e0:
            j += 1
        for lab, s, e in host[j:]:
            if s > mid:
                break
            if s <= mid <= e:
                label = lab
        tot[label] = tot.get(label, 0.0) + (s1 - e0) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:count]]
