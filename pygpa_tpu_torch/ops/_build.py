"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) and linked into one shared library with a plain C
interface, at first use, into ``pygpa_tpu_torch/_build/`` (listed in
.gitignore). The library's file name carries a hash of the sources, the
headers they share (``csrc/*.cuh``) and the nvcc command, so an edit
rebuilds and a stale library is never loaded. It is bound with
``ctypes``: each launcher takes raw device pointers (``data_ptr()``)
and the caller's CUDA stream, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; :func:`check`
raises on a non-zero code. :func:`bind` declares a launcher's argument
types once and caches it, so a launch costs one dictionary lookup.
``build_log`` keeps nvcc's output of the last build, with ptxas's
registers, shared memory and spills of every kernel (``-Xptxas -v``).

No source includes PyTorch's headers, so the build takes seconds, not
the minutes of ``torch.utils.cpp_extension.load``.
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lib = None
_bound = {}     # (name, layout) -> bound launcher
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
build_seconds = None
build_log = ""

# kernel launches per wrapper name; a wrapper adds one where it
# launches its kernel and nowhere else (a run shows which kernels its
# main path went through by clearing this and reading it afterwards)
launches = collections.Counter()


def find_nvcc():
    """Path of nvcc: $CUDACXX, then PATH, then $CUDA_HOME/bin,
    $CUDA_PATH/bin and the toolkit's default homes. Returns None when
    there is none."""
    cand = [os.environ.get("CUDACXX"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *CUDA_HOMES):
        if home:
            cand.append(os.path.join(home, "bin", "nvcc"))
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(nvcc, flags):
    h = hashlib.sha256()
    h.update(" ".join([nvcc] + flags).encode())
    for p in sorted(sources() + list(SRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile csrc/*.cu into BUILD_DIR (unless the same sources were
    already built), one nvcc process per source run side by side, link
    them into one library and return its path. Raises RuntimeError
    when nvcc is missing or the compile fails."""
    global build_seconds, build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "pygpa_tpu_torch: the CUDA kernels need nvcc (CUDA toolkit "
            "with sm_90a support) and none was found on PATH, $CUDACXX, "
            "$CUDA_HOME or /usr/local/cuda; CUDA tensors cannot be "
            "processed without them")
    lib_path = BUILD_DIR / f"libpygpa_kernels_{_digest(nvcc, NVCC_FLAGS)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], False
        for _, proc in procs:
            logs.append(proc.communicate()[0])
            failed |= proc.returncode != 0
        if not failed:
            so = os.path.join(tmp, "lib.so")
            link = subprocess.run(
                [nvcc, "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o", so]
                + [obj for obj, _ in procs], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = link.returncode != 0
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"pygpa_tpu_torch: nvcc failed:\n{build_log}")
        os.replace(so, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def bind(name, layout):
    """ctypes function `name` of the library with its argument types
    declared: `layout` is a string of 'p' (device pointer or stream),
    'i' (int) and 'f' (float) codes, in order. Bound once per (name,
    layout), each as its own function object, so two layouts of one
    name never share argument types; later calls return the cached
    function."""
    key = (name, layout)
    fn = _bound.get(key)
    if fn is None:
        fn = load()[name]           # a new function object per lookup
        fn.argtypes = [_CTYPES[c] for c in layout]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def check(code, name):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"pygpa_tpu_torch: CUDA kernel {name} failed "
                           f"to launch (cudaError {code})")


def check_tensor(op, name, t, shape, dtype, device):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (what a launcher may be handed)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{op}: {name} must be a contiguous {dtype} tensor "
                         f"of shape {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def graph_kernels(fn):
    """Names of the CUDA kernels one call of fn() launches, one a launch,
    read from a CUDA graph captured from the call (torch.cuda.CUDAGraph
    with keep_graph, printed by libcuda's cuGraphDebugDotPrint); copies
    and fills left out. Unlike a torch.profiler trace, which can lose a
    prefix of a process's device events (scripts/profiler_loss.py), it
    cannot miss a launch. A warm-up call runs first; the captured call
    does not run. For checks on the card, not used by any route."""
    import re
    import torch
    fn()
    torch.cuda.synchronize()
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint]
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "call.dot")
        code = drv.cuGraphDebugDotPrint(g.raw_cuda_graph(), path.encode(), 0)
        if code != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint failed ({code})")
        with open(path) as f:
            dot = f.read()
    g.reset()
    torch.cuda.synchronize()
    # each node's label is its index, then its kind (MEMSET, MEMCPY, ...)
    # or, for a kernel node, the kernel's name
    kinds = re.findall(r'label="\d+\n([^\n"]*)', dot)
    return [k for k in kinds if not re.fullmatch(r"[A-Z_]+", k)]
