"""Where a cell's calls take their inputs from, as its traffic names it.

- "pool": `pool` distinct frames made on the device at set-up; a call
  takes `batch` of them (one frame, or a stack of `batch`), the pool's
  images or stacks in a seeded order, repeated.
- "mosaic": a `side`^2 uint16 GPAM mosaic written at set-up under the
  temporary directory; a call reads the next `batch` tiles of `tile`^2
  with the program's tile loader (data.MosaicTiles.batches), in one pass
  after another, and moves them to the device.
"""
import os
import time

import numpy as np
import torch

from . import inputs
from .trace import phase


class Pool:
    def __init__(self, cfg, traffic, seed, device):
        n = int(cfg["shape"][0])
        self.batch = int(traffic["batch"])
        count = int(traffic["pool"])
        frames, self.params = inputs.frame_pool(cfg["lattice"], n, count,
                                                traffic, seed, device)
        if self.batch == 1:
            self.items = [frames[i] for i in range(count)]
        else:
            self.items = [frames[i:i + self.batch].contiguous()
                          for i in range(0, count, self.batch)]
        del frames
        self.order = np.random.default_rng([seed, 2]).permutation(
            len(self.items))
        self.pixels = self.batch * n * n
        self.k = 0

    def warm_items(self):
        return list(range(len(self.items)))

    def next(self, traced=False, read_ms=None, keep=False):
        i = int(self.order[self.k % len(self.order)])
        self.k += 1
        return i, self.items[i]

    def item(self, i):
        return self.items[i]

    def keep_last(self, i):
        pass

    def close(self):
        self.items = []


class Mosaic:
    def __init__(self, cfg, traffic, seed, device):
        from pygpa_tpu_torch import data
        self.data = data
        self.device = device
        self.side = int(traffic["side"])
        self.tile = int(traffic["tile"])
        self.batch = int(traffic["batch"])
        self.path, self.params = inputs.write_mosaic(
            cfg["lattice"], self.side, traffic["mosaic"], seed, device)
        self.tiles = data.MosaicTiles(self.path)
        self.origins = self.tiles.grid(self.tile)
        self.per_pass = -(-len(self.origins) // self.batch)
        self.pixels = self.batch * self.tile * self.tile
        self.it = None
        self.k = 0
        self.kept = {}          # batch index -> tiles as read (host)
        self.last = None

    def warm_items(self):
        return list(range(self.per_pass))

    def next(self, traced=False, read_ms=None, keep=False):
        b = self.k % self.per_pass
        self.k += 1
        if b == 0 or self.it is None:
            self.it = self.tiles.batches(self.tile, batch_size=self.batch)
        with phase("read", traced):
            t0 = time.perf_counter()
            host, _ = next(self.it)
            if read_ms is not None:
                read_ms.append((time.perf_counter() - t0) * 1e3)
        if keep:
            self.kept[b] = host
        self.last = host
        with phase("to_card", traced):
            x = torch.as_tensor(host, device=self.device)
        return b, x

    def keep_last(self, b):
        self.kept[b] = self.last

    def batch_origins(self, b):
        chunk = self.origins[b * self.batch:(b + 1) * self.batch]
        return chunk + [chunk[-1]] * (self.batch - len(chunk))

    def close(self):
        self.tiles.close()
        if self.path and os.path.exists(self.path):
            os.remove(self.path)
        self.path = None


SOURCES = {"pool": Pool, "mosaic": Mosaic}


def make(cfg, traffic, seed, device):
    kind = traffic["source"]
    if kind not in SOURCES:
        raise KeyError(f"unknown input source {kind!r}")
    return SOURCES[kind](cfg, traffic, seed, device)
