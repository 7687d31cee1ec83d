#!/usr/bin/env python3
"""Where a stage-2 consumer thread's cycles go, on one CUDA card:

    python3 scripts/stage2_clock.py [--P 42] [--W1 256]

Copies pygpa_tpu_torch into a temporary directory, puts clock64() timers
around each wait of csrc/sweep_tc.cuh's wg_sweep_tile (the text
replacements below must match its source) and a device-side counter
beside them, builds that copy, runs the zoom tournament
(ops.zoom_sweep.stage2) once at a 4096^2 frame on seeded random T and
basis, and prints, for thread 0 (warpgroup 0, which also issues the TMA
loads) and thread 128 (warpgroup 1), the mean cycles a block spends in
the whole tile, waiting for a stage's loads (full barrier), in
wgmma.wait_group 1 and 0, issuing the next loads (thread 0's wait for
the slot and its TMA), loading and splitting A fragments, and in the
stage-end sums, with the card's name and power limit. The rest of a
tile's cycles are the wgmma issue and the tournament. The timers
themselves cost a few percent.
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("tile", "full_wait", "wait_group_1", "wait_group_0", "next_loads",
         "stage_sums", "fragments")
PATCHES = [
    ("constexpr int WNT = 256;",
     "__device__ unsigned long long g_clock[16];\nconstexpr int WNT = 256;"),
    ("""  for (int s = 0; s < total; ++s) {
    const int slot = s % WSTAGES;
    mbar_wait(full + 8 * slot, (s / WSTAGES) & 1);""",
     """  long long k[7] = {};
  const long long k0 = clock64();
  for (int s = 0; s < total; ++s) {
    const int slot = s % WSTAGES;
    long long c = clock64();
    mbar_wait(full + 8 * slot, (s / WSTAGES) & 1);
    k[1] += clock64() - c;"""),
    ("""      if (kk >= 2) wg_wait<1>();
      uint32_t rh[4], rl[4], ih[4], il[4];""",
     """      long long c1 = clock64();
      if (kk >= 2) wg_wait<1>();
      k[2] += clock64() - c1;
      c1 = clock64();
      uint32_t rh[4], rl[4], ih[4], il[4];"""),
    ("""      wg_fence();
      const uint32_t b = bb + kk * 32;""",
     """      k[6] += clock64() - c1;
      wg_fence();
      const uint32_t b = bb + kk * 32;"""),
    ("""    if (tid == 0 && s + WAHEAD < total) load(s + WAHEAD);
    __syncwarp();
    wg_wait<0>();""",
     """    long long c2 = clock64();
    if (tid == 0 && s + WAHEAD < total) load(s + WAHEAD);
    __syncwarp();
    k[4] += clock64() - c2;
    c2 = clock64();
    wg_wait<0>();
    k[3] += clock64() - c2;
    c2 = clock64();"""),
    ("""    if (s % nk == nk - 1) {  // candidate s / nk complete""",
     """    k[5] += clock64() - c2;
    if (s % nk == nk - 1) {  // candidate s / nk complete"""),
    ("""        sr[e] = si[e] = 0.f;
      }
    }
  }
}
""", """        sr[e] = si[e] = 0.f;
      }
    }
  }
  k[0] = clock64() - k0;
  if (tid == 0 || tid == 128) {
    unsigned long long* o = g_clock + (tid ? 8 : 0);
    for (int q = 0; q < 7; ++q) atomicAdd(o + q, (unsigned long long)k[q]);
    atomicAdd(o + 7, 1ull);
  }
}
"""),
]
READER = """
extern "C" int stage2_clock(unsigned long long* h, int reset) {
  if (reset) {
    unsigned long long z[16] = {};
    return (int)cudaMemcpyToSymbol(g_clock, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(h, g_clock, 16 * sizeof(long long));
}
"""
CHILD = r"""
import ctypes, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
from pygpa_tpu_torch.ops import _build, zoom_sweep as zs
P, W1 = int(sys.argv[3]), int(sys.argv[4])
print(cs.card_line(), flush=True)
fn = _build.load().stage2_clock
fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
T = torch.randn(P, 4096, 2 * W1, device=dev, generator=g)
c = torch.randn(4096, W1, device=dev, generator=g)
s = torch.randn(4096, W1, device=dev, generator=g)
zs.stage2(T, c, s, None)
torch.cuda.synchronize()
fn(None, 1)
zs.stage2(T, c, s, None)
torch.cuda.synchronize()
buf = (ctypes.c_ulonglong * 16)()
fn(ctypes.addressof(buf), 0)
names = sys.argv[5].split(",")
for who, o in (("thread 0", 0), ("thread 128", 8)):
    n = buf[o + 7]
    print(f"P={P} W1={W1} {who}: mean cycles a block " + str(
        {k: buf[o + i] / n for i, k in enumerate(names)}) + f" ({n} blocks)")
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--P", type=int, default=42)
    ap.add_argument("--W1", type=int, default=256)
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="stage2_clock")
    try:
        pkg = os.path.join(tmp, "pygpa_tpu_torch")
        shutil.copytree(os.path.join(HERE, "pygpa_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        path = os.path.join(pkg, "csrc", "sweep_tc.cuh")
        src = open(path).read()
        for old, new in PATCHES:
            if src.count(old) != 1:
                raise SystemExit("stage2_clock: csrc/sweep_tc.cuh no longer "
                                 f"holds the text to time:\n{old}")
            src = src.replace(old, new)
        open(path, "w").write(src)
        with open(os.path.join(pkg, "csrc", "zoom_sweep.cu"), "a") as f:
            f.write(READER)
        return subprocess.run([sys.executable, "-c", CHILD, tmp, HERE,
                               str(args.P), str(args.W1), ",".join(NAMES)]
                              ).returncode
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
