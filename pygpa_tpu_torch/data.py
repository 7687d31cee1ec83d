"""Mosaic tile loading: the native data path of the batch pipelines
(counterpart of pygpa_tpu/data.py, the same "GPAM" format, names and
semantics).

Large stitched mosaics (8k^2+ LEEM/STM scans) are processed as stacks of
tiles: make_displacement_extractor's run takes a (B, n, m) stack, and
parallel.extract_displacement_field_batch maps the eager pipeline over
one. Tile extraction runs in a memory-mapped, multithreaded C++ loader
(csrc/tileloader.cpp, this package's own copy of the JAX package's
native/tileloader.cpp), compiled with g++ at first use into _build/ and
bound via ctypes, so host IO can overlap device compute. There is no
Python fallback: without g++ the first use raises.

read_tiles returns float32 numpy arrays on the host, as the reference's
does; moving a stack to the card is the pipeline's job
(torch.as_tensor(tiles, device=...)).

File format "GPAM": 32-byte header (magic, dtype code, H, W) + row-
major pixels; write_mosaic() creates it from an array.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32, 3: np.float64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "tileloader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None


def build():
    """Compile csrc/tileloader.cpp with g++ into BUILD_DIR (unless the
    same source was built with the same flags already) and return the
    library's path. Raises RuntimeError when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("pygpa_tpu_torch.data: the tile loader needs g++ "
                           "to build csrc/tileloader.cpp and none is on PATH")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libtileloader_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        proc = subprocess.run([gxx] + CXX_FLAGS + [str(SOURCE), "-o", out],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("pygpa_tpu_torch.data: g++ failed on "
                               f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(out, so)
    return so


def _load_library():
    """Build (once) and load the native loader."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [ctypes.c_char_p]
    lib.tl_info.restype = ctypes.c_int
    lib.tl_info.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.tl_read_tiles.restype = ctypes.c_int
    lib.tl_read_tiles.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int]
    lib.tl_close.restype = None
    lib.tl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def write_mosaic(path, array):
    """Write a 2-D array (uint8, uint16, float32 or float64) as a GPAM
    mosaic file."""
    array = np.ascontiguousarray(array)
    code = _CODES[array.dtype]
    with open(path, "wb") as f:
        f.write(b"GPAM")
        f.write(np.uint32(code).tobytes())
        f.write(np.uint64(array.shape[0]).tobytes())
        f.write(np.uint64(array.shape[1]).tobytes())
        f.write(np.uint64(0).tobytes())
        f.write(array.tobytes())


class MosaicTiles:
    """Memory-mapped tiled view of a mosaic file.

    Usage::

        with MosaicTiles("scan.gpam") as mt:
            fn = make_displacement_extractor((2048, 2048), ks)
            for batch, coords in mt.batches(tile=2048, batch_size=8):
                us = fn(torch.as_tensor(batch, device="cuda"))
    """

    def __init__(self, path, nthreads=None):
        self._h = None
        self._lib = _load_library()
        self._h = self._lib.tl_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open mosaic {path!r}")
        dt = ctypes.c_uint32()
        hh = ctypes.c_uint64()
        ww = ctypes.c_uint64()
        self._lib.tl_info(self._h, ctypes.byref(dt), ctypes.byref(hh),
                          ctypes.byref(ww))
        self.dtype = np.dtype(_DTYPES[dt.value])
        self.shape = (int(hh.value), int(ww.value))
        self.nthreads = nthreads or min(16, os.cpu_count() or 1)

    def read_tiles(self, origins, tile, normalize=True):
        """Extract tiles of shape `tile` at the given (y, x) origins.
        Returns a float32 (ntiles, th, tw) numpy array (edge tiles clamp
        to the border). normalize subtracts each tile's mean in-pass (the
        pipelines' first step)."""
        th, tw = (tile, tile) if np.isscalar(tile) else tile
        origins = np.asarray(origins, np.int64).reshape(-1, 2)
        n = len(origins)
        out = np.empty((n, th, tw), np.float32)
        ys = np.ascontiguousarray(origins[:, 0])
        xs = np.ascontiguousarray(origins[:, 1])
        rc = self._lib.tl_read_tiles(
            self._h, ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, th, tw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.nthreads, int(bool(normalize)))
        if rc != 0:
            raise RuntimeError("tile read failed")
        return out

    def grid(self, tile, overlap=0):
        """(y, x) origins of a full tiling with `overlap` pixels."""
        th, tw = (tile, tile) if np.isscalar(tile) else tile
        sy = max(1, th - overlap)
        sx = max(1, tw - overlap)
        ys = list(range(0, max(self.shape[0] - overlap, 1), sy))
        xs = list(range(0, max(self.shape[1] - overlap, 1), sx))
        return [(y, x) for y in ys for x in xs]

    def batches(self, tile, batch_size, overlap=0, normalize=True):
        """Yield (tiles (B, th, tw) float32 numpy, origins list) batches
        covering the mosaic; the trailing batch is padded by repeating
        its last tile, so every stack has one shape (one plan of the
        extractor serves them all)."""
        origins = self.grid(tile, overlap)
        for i in range(0, len(origins), batch_size):
            chunk = origins[i: i + batch_size]
            pad = batch_size - len(chunk)
            full = chunk + [chunk[-1]] * pad
            yield self.read_tiles(full, tile, normalize), chunk

    def close(self):
        if self._h:
            self._lib.tl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
