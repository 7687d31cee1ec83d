"""One run of one cell: set-up, a closed-loop window of --seconds, the
metrics, the check of sampled outputs against the plain reference, and
the result's last line (see gpabench/run.py)."""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np

from . import bench, check, entries, sources, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pygpa_tpu")


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="gpabench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (pygpa_tpu_torch is not pygpa_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Run:
    """What a window recorded, for the metrics' readers."""

    def __init__(self, cell, source, entry):
        self.cell = cell
        self.pixels = source.pixels
        self.batch = source.batch
        self.calls_ms = []
        self.read_ms = []
        self.stages = []            # per call: [(name, cuda event)]
        self.window_s = None
        self.trace = None           # (device records, host phases)
        self.traced_calls = 0
        self.launches = {}          # counter -> launches a traced call
        self.plan = entry.plan_shape() if hasattr(entry, "plan_shape") \
            else None
        self.shape = tuple(cell.config["shape"])

    def stage_ms(self):
        return [entries.stage_ms(ev) for ev in self.stages]


def sync(device):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def to_host(out):
    """A call's outputs with every tensor copied to the host."""
    import torch
    return {k: (v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def sample_calls(seed, traffic):
    spec = traffic["check"]
    rng = np.random.default_rng([seed, 3])
    return sorted(set(int(v) for v in rng.integers(
        0, int(spec["within"]), int(spec["samples"]))))


def window(cell, src, entry, seconds, traced, device, keep_at):
    """The closed loop: calls back to back for `seconds`, each ending in a
    device synchronize. Returns (Run, kept {call: (item, host outputs)})
    of the drawn calls."""
    from pygpa_tpu_torch.ops import _build
    run = Run(cell, src, entry)
    trace_s = float(cell.traffic.get("trace_seconds", 6.0))
    kept = {}
    prof = None
    ctx = None
    launches0, k0 = None, 0
    stages = run.stages if traced else None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = None
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        k = len(run.calls_ms)
        if traced and ctx is None and now >= deadline - trace_s:
            ctx = trace.profiled()
            prof = ctx.__enter__()
            launches0, k0 = dict(_build.launches), k
        keep = k in keep_at
        tc = time.perf_counter()
        item, x = src.next(traced=ctx is not None, read_ms=run.read_ms,
                           keep=keep)
        out = entry(x, stages, ctx is not None)
        sync(device)
        run.calls_ms.append((time.perf_counter() - tc) * 1e3)
        if keep:
            kept[k] = (item, to_host(out))
        last = (k, item, out)
    run.window_s = time.perf_counter() - t0
    if ctx is not None:
        run.traced_calls = len(run.calls_ms) - k0
        counted = {c: v - launches0.get(c, 0)
                   for c, v in _build.launches.items()}
        ctx.__exit__(None, None, None)
        run.trace = prof.events
        run.launches = {c: v / run.traced_calls for c, v in counted.items()
                        if v}
    # the drawn calls that the window did not reach: its last call instead
    k, item, out = last
    if max(keep_at) > k:
        src.keep_last(item)
        kept[k] = (item, to_host(out))
    del out, last
    return run, kept


def end_to_end(cell, run, setup_s, peak):
    calls = run.calls_ms
    p90 = statistics.quantiles(calls, n=10, method="inclusive")[8] \
        if len(calls) >= 2 else calls[0]
    values = {"mpix_s": len(calls) * run.pixels / run.window_s / 1e6,
              "call_p90_ms": p90,
              "peak_mem_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell, run):
    out = {}
    for m in cell.per_layer:
        v = bench.metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judge(cell, src, entry, kept, device):
    """The numbers compared, from every kept call."""
    kind = cell.config["entry"]["kind"]
    numbers = {}

    def worst(d):
        check.worst(numbers, d)

    for k, (item, out) in sorted(kept.items()):
        if kind == "quickstart":
            worst(check.judge_quickstart(src.item(item), out,
                                         entry.z, device))
        elif cell.traffic["source"] == "mosaic":
            border = 4 * entry.run.sigma
            worst(check.judge_mosaic(
                src.path, src.batch_origins(item), src.tile,
                src.kept[item], out["u"], out["props"], entry.ks, device,
                border, entry.coarse))
        else:
            imgs = src.item(item)
            imgs = imgs[None] if imgs.dim() == 2 else imgs
            us = out["u"][None] if out["u"].dim() == 3 else out["u"]
            worst(check.judge_factory(imgs, us, entry.ks, device,
                                      4 * entry.run.sigma, entry.coarse))
    return numbers


def run_cell(cell, seed, seconds, traced, device, t_start):
    """Set-up, window, metrics and check of one run. Returns the result
    object (the last line) or raises."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup = {}
    t = time.perf_counter()
    setup["import"] = t - t_start
    import pygpa_tpu_torch  # noqa: F401
    from pygpa_tpu_torch.ops import _build
    if device == "cuda":
        _build.load()
    setup["build_or_load"] = time.perf_counter() - t
    t = time.perf_counter()
    src = sources.make(cell.config, cell.traffic, seed, device)
    sync(device)
    setup["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    entry = entries.make(cell.config, cell.traffic, device)
    sync(device)
    setup["entry"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in src.warm_items():
        _, x = src.next()
        entry(x)
    sync(device)
    setup["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    say("setup_s " + json.dumps({k: round(v, 4) for k, v in setup.items()})
        + f" total {setup_s:.4f}")
    keep_at = sample_calls(seed, cell.traffic)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run, kept = window(cell, src, entry, seconds, traced, device, keep_at)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    say(f"calls: {len(run.calls_ms)} in a window of {run.window_s:.4f} s "
        f"(judged: {sorted(kept)})")
    if traced:
        metrics = per_layer(cell, run)
        dev, _ = run.trace
        seen = {k: c for k, (c, _) in trace.kernel_stats(dev).items()}
        say(f"launches seen in the trace over {run.traced_calls} calls: "
            f"{json.dumps(seen)}; counted by the program a call: "
            f"{json.dumps(run.launches)}")
    else:
        metrics = end_to_end(cell, run, setup_s, peak)
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": torch.cuda.get_device_name(0) if device == "cuda"
                else device,
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        dev, host = run.trace
        busy, span = trace.busy_and_span(dev)
        dev_info["busy_s"] = busy
        dev_info["window_s"] = span
        breakdown = {"device_ops": trace.top_device_ops(dev),
                     "idle_gaps": trace.idle_gaps(dev, host)}
    attempted = len(run.calls_ms)
    # the program's state goes before the reference runs
    del run
    entry_kind = cell.config["entry"]["kind"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = judge(cell, src, entry, kept, device)
    src.close()
    ok, lines = check.verdict(numbers, cell.limits)
    say(f"check: {entry_kind} reference over {len(kept)} calls in "
        f"{time.perf_counter() - t:.1f} s; card: {card_line()}")
    result = {"correct": bool(ok), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in lines}
    for n, v, lim, good in lines:
        say(f"check {n} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    return result


def main(argv, t_start):
    args = parse(argv)
    try:
        cell = bench.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        say(f"gpabench: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"gpabench: {args.workload} needs {cell.chips} CUDA device(s), "
            f"found {torch.cuda.device_count()}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        say(f"gpabench: the run loaded {bad}; no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0
