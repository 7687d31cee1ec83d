"""ops.kernel_smoke on the CPU: every hand-kernel entry runs (through its
wrapper, which takes the plain twin for a CPU tensor) at its small
fixture and gives finite outputs of the right shapes; the card's run,
where each entry must also raise its kernel's launch counter, is in
chip_smoke.py."""
import pytest

from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops.kernel_smoke import ENTRIES, run_kernel_smoke


@pytest.fixture(scope="module")
def smoke_log():
    import contextlib
    import io
    _build.launches.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = run_kernel_smoke(verbose=True, device="cpu")
    return ok, buf.getvalue().splitlines()


def test_kernel_smoke_runs_on_the_cpu(smoke_log):
    ok, _ = smoke_log
    assert ok is True
    # the twins ran: no launch counted
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_kernel_smoke_visits_entry(smoke_log, name):
    _, lines = smoke_log
    assert f"  kernel-smoke: {name} ok" in lines


def test_kernel_smoke_refuses_a_missing_card():
    """With no device the smoke runs on the card: without CUDA it raises
    instead of running the twins."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs this path")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        run_kernel_smoke()


def test_kernel_smoke_covers_every_launch_counter():
    """Every launch counter a kernel wrapper of ops/ raises (each
    `_build.launches[...] += 1`) belongs to an entry of the smoke, the
    early-stopping CG's "cg_unwrap" among them."""
    import pathlib
    import re
    ops = pathlib.Path(_build.__file__).parent
    counters = set()
    for src in ops.glob("*.py"):
        counters |= set(re.findall(r'launches\["(\w+)"\] \+= 1',
                                   src.read_text()))
    covered = {c for names in ENTRIES.values() for c in names}
    assert "cg_unwrap" in counters
    assert counters <= covered, counters - covered
