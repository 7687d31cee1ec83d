"""The port's mosaic tile loader (pygpa_tpu_torch.data) on the CPU: the
eight cases of tests/test_data.py against its MosaicTiles, GPAM files
crossing between the two packages, its own build under
pygpa_tpu_torch/_build/ (nothing written to native/), and loader
batches through the port's extract_displacement_field_batch held to the
reference's."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pygpa_tpu import data as jdata
from pygpa_tpu_torch import data

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mosaic_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    arr = rng.uniform(0, 100, size=(300, 420)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("mosaic") / "scan.gpam")
    data.write_mosaic(path, arr)
    return path, arr


def test_open_info(mosaic_file):
    path, arr = mosaic_file
    with data.MosaicTiles(path) as mt:
        assert mt.shape == arr.shape
        assert mt.dtype == np.float32


def test_read_tiles_matches_numpy(mosaic_file):
    path, arr = mosaic_file
    with data.MosaicTiles(path, nthreads=4) as mt:
        origins = [(0, 0), (100, 50), (37, 123), (128, 256)]
        tiles = mt.read_tiles(origins, 64, normalize=False)
        assert tiles.dtype == np.float32 and isinstance(tiles, np.ndarray)
        for t, (y, x) in zip(tiles, origins):
            assert np.allclose(t, arr[y:y + 64, x:x + 64])


def test_normalize_subtracts_mean(mosaic_file):
    path, arr = mosaic_file
    with data.MosaicTiles(path) as mt:
        tiles = mt.read_tiles([(10, 10)], 64, normalize=True)
        ref = arr[10:74, 10:74]
        assert np.allclose(tiles[0], ref - ref.mean(), atol=1e-3)
        assert abs(tiles[0].mean()) < 1e-3


def test_edge_clamping(mosaic_file):
    path, arr = mosaic_file
    with data.MosaicTiles(path) as mt:
        t = mt.read_tiles([(280, 400)], 64, normalize=False)[0]
        # rows/cols beyond the border replicate the last one
        assert np.allclose(t[:20, :20], arr[280:300, 400:420])
        assert np.allclose(t[25, 5], arr[299, 405])
        assert np.allclose(t[5, 30], arr[285, 419])


def test_uint16_conversion(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 60000, size=(80, 90)).astype(np.uint16)
    path = str(tmp_path / "u16.gpam")
    data.write_mosaic(path, arr)
    with data.MosaicTiles(path) as mt:
        assert mt.dtype == np.uint16
        t = mt.read_tiles([(0, 0)], (80, 90), normalize=False)[0]
        assert np.allclose(t, arr.astype(np.float32))


def test_batches_cover_grid(mosaic_file):
    path, arr = mosaic_file
    with data.MosaicTiles(path) as mt:
        seen = []
        for tiles, coords in mt.batches(128, batch_size=4):
            assert tiles.shape == (4, 128, 128)
            assert tiles.dtype == np.float32
            seen.extend(coords)
        grid = mt.grid(128)
        assert seen == grid
        assert (0, 0) in seen
        # the trailing batch repeats its last tile: 12 tiles in 5s
        last, coords = list(mt.batches(128, batch_size=5))[-1]
        assert last.shape == (5, 128, 128)
        pad = 5 - len(coords)
        assert pad > 0
        for k in range(pad):
            np.testing.assert_array_equal(last[len(coords) + k],
                                          last[len(coords) - 1])


def test_pipeline_integration(tmp_path):
    """Loader batches through the port's extract_displacement_field_batch
    on the CPU (the reference's test_pipeline_integration), held to the
    reference's on the same float32 batch within 1e-3 px on the 8-px
    interior (tests/test_torch_exact.py's bound for the eager path)."""
    from pygpa_tpu.lattices import generate_ks, hexlattice_gen
    from pygpa_tpu.parallel import (
        extract_displacement_field_batch as j_batch)
    from pygpa_tpu_torch.parallel import extract_displacement_field_batch
    big = np.array(hexlattice_gen(0.12, 9.0, order=1, size=256,
                                  dtype=np.float64)).astype(np.float32)
    path = str(tmp_path / "lat.gpam")
    data.write_mosaic(path, big)
    ks = np.array(generate_ks(0.12, 9.0))[:3]
    with data.MosaicTiles(path) as mt:
        tiles, coords = next(iter(mt.batches(128, batch_size=4)))
    us = extract_displacement_field_batch(tiles, ks, device="cpu")
    assert us.shape == (4, 2, 128, 128) and us.dtype == torch.float32
    assert torch.isfinite(us).all()
    want = np.asarray(j_batch(tiles, ks))
    assert np.abs(us.numpy() - want)[..., 8:-8, 8:-8].max() < 1e-3


@pytest.fixture
def reference_loader(tmp_path, monkeypatch):
    """The reference's loader built from a copy of its source in a
    private directory, so this test never races another process
    building native/libtileloader.so."""
    priv = tmp_path / "native"
    priv.mkdir()
    shutil.copy(os.path.join(ROOT, "native", "tileloader.cpp"), priv)
    monkeypatch.setattr(jdata, "_native_dir", lambda: str(priv))
    monkeypatch.setattr(jdata, "_lib", None)
    return jdata


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_between_the_packages(tmp_path, reference_loader,
                                          writer):
    """A GPAM file written by either package reads the same through the
    other's loader (uint16 and float64 pixels, edge tiles, normalize)."""
    rng = np.random.default_rng(2)
    arrs = {"u16": rng.integers(0, 60000, size=(70, 90)).astype(np.uint16),
            "f64": rng.normal(size=(70, 90))}
    jd = reference_loader
    write = data.write_mosaic if writer == "port" else jd.write_mosaic
    origins = [(0, 0), (40, 50), (-5, 70)]
    for name, arr in arrs.items():
        path = str(tmp_path / f"{name}.gpam")
        write(path, arr)
        with data.MosaicTiles(path) as mt, jd.MosaicTiles(path) as jt:
            assert mt.shape == jt.shape == arr.shape
            assert mt.dtype == jt.dtype == arr.dtype
            for norm in (False, True):
                np.testing.assert_array_equal(
                    mt.read_tiles(origins, 32, normalize=norm),
                    jt.read_tiles(origins, 32, normalize=norm))


def test_loader_builds_its_own_copy(tmp_path):
    """In a fresh interpreter with pygpa_tpu and JAX blocked, the port
    builds csrc/tileloader.cpp with g++ (into a fresh build directory
    here) and loads that library, and no file under native/ is opened,
    compiled or loaded on the way (an audit hook watches every open,
    process and dlopen); the default build directory is
    pygpa_tpu_torch/_build/."""
    assert data.BUILD_DIR == Path(ROOT, "pygpa_tpu_torch", "_build")
    assert data.SOURCE == Path(ROOT, "pygpa_tpu_torch", "csrc",
                               "tileloader.cpp")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pygpa_tpu'] = None\n"
        "seen = []\n"
        f"NATIVE = {os.path.join(ROOT, 'native')!r}\n"
        "def hook(ev, args):\n"
        "    if ev in ('open', 'subprocess.Popen', 'os.exec',\n"
        "              'os.posix_spawn', 'ctypes.dlopen') \\\n"
        "            and NATIVE in repr(args):\n"
        "        seen.append((ev, repr(args)))\n"
        "sys.addaudithook(hook)\n"
        "import numpy as np\n"
        "from pathlib import Path\n"
        "from pygpa_tpu_torch import data\n"
        f"data.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        "so = data.build()\n"
        "assert so.parent == data.BUILD_DIR and so.exists(), so\n"
        f"p = {str(tmp_path / 'x.gpam')!r}\n"
        "data.write_mosaic(p, np.arange(64, dtype=np.uint8).reshape(8, 8))\n"
        "with data.MosaicTiles(p) as mt:\n"
        "    assert mt._lib._name == str(so)\n"
        "    t = mt.read_tiles([(0, 0)], 8, normalize=False)[0]\n"
        "    assert (t == np.arange(64).reshape(8, 8)).all()\n"
        "assert not seen, seen\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
