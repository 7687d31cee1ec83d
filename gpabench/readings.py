#!/usr/bin/env python3
"""The two readings each limit of gpabench/limits/<cell>.json is set
from, on a CUDA card at the cell's own size, in one process:

    python3 gpabench/readings.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--calls N]

For each seed: the cell's inputs from the seed, the program's outputs of
`calls` calls (the drawn calls of a run: the traffic's check samples),
each judged against the reference as a run judges them (the lower
reading is the largest over the seeds); for each control seed the
control, the reference with bfloat16 storage put in the program's place,
judged the same way (the upper reading is the smallest). One JSON line a
reading; the benchmark's runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_numbers(cell, src, entry, item, device):
    import torch
    from gpabench.harness import check
    from gpabench.reference import props as rprops
    from gpabench.reference.precision import Store
    bf = Store("bfloat16")
    kind = cell.config["entry"]["kind"]
    if kind == "quickstart":
        img = src.item(item).to(device, torch.float64)
        out = check.quickstart_outputs(img, entry.z, bf)
        return check.judge_quickstart(img, out, entry.z, device)
    border = 4 * entry.run.sigma
    if cell.traffic["source"] == "mosaic":
        origins = src.batch_origins(item)
        tiles, us, props = [], [], []
        for o in origins:
            t = torch.as_tensor(rprops.tile(src.path, o, src.tile))
            t = bf(t)
            u = check.factory_reference(t, entry.ks, device, entry.coarse,
                                        bf)
            tw, al, ka = rprops.props(u, bf)
            tiles.append(t.numpy())
            us.append(u.cpu())
            props.append(torch.stack([tw, torch.zeros_like(tw), al,
                                      ka]).cpu())
        return check.judge_mosaic(src.path, origins, src.tile, tiles, us,
                                  props, entry.ks, device, border,
                                  entry.coarse)
    imgs = src.item(item)
    imgs = imgs[None] if imgs.dim() == 2 else imgs
    us = [check.factory_reference(im, entry.ks, device, entry.coarse,
                                  bf).cpu() for im in imgs]
    return check.judge_factory(imgs, us, entry.ks, device, border,
                               entry.coarse)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=None)
    args = ap.parse_args()
    import torch
    from gpabench.harness import bench, check, entries, main as hm, sources
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    cell = bench.find_cell(args.workload)
    from pygpa_tpu_torch.ops import _build
    _build.load()
    entry = entries.make(cell.config, cell.traffic, device)
    calls = args.calls or int(cell.traffic["check"]["samples"])
    print(json.dumps({"card": hm.card_line(), "workload": cell.name}),
          flush=True)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        src = sources.make(cell.config, cell.traffic, seed, device)
        kept = {}
        for k in range(calls):
            item, x = src.next(keep=True)
            kept[k] = (item, hm.to_host(entry(x)))
        torch.cuda.synchronize()
        if seed in args.seeds:
            numbers = hm.judge(cell, src, entry, kept, device)
            print(json.dumps({"seed": seed, "side": "program",
                              "numbers": numbers,
                              "s": round(time.perf_counter() - t, 1)}),
                  flush=True)
        if seed in args.control_seeds:
            t = time.perf_counter()
            worst = {}
            for k, (item, _) in kept.items():
                check.worst(worst, control_numbers(cell, src, entry, item,
                                                   device))
            print(json.dumps({"seed": seed, "side": "control",
                              "numbers": worst,
                              "s": round(time.perf_counter() - t, 1)}),
                  flush=True)
        src.close()
        del src, kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
