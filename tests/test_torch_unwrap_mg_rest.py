"""The rest of the port's multigrid unwrap (pygpa_tpu_torch.solvers.
unwrap): the unweighted problem, the "vv" V-branch, the schedule= and
v_coarse_mult= keywords, and the reference's API-parity names, against
pygpa_tpu on the CPU (on its XLA route, and once on its kernels in
interpret mode). Inputs are float32 planes made with numpy from a seed (float64
where a test says so); the two displacement components are the port's
batch axis and a vmap on the reference side. Tolerances are the
reference multigrid test's: max |port - reference| within 1e-4 of the
reference's largest value in float32, 1e-10 in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.solvers.unwrap as JU
import pygpa_tpu_torch.solvers as tsolvers
import pygpa_tpu_torch.solvers.unwrap as TU
from pygpa_tpu_torch.ops import vcycle as tvc
from test_torch_unwrap import _close, _problem

torch.set_num_threads(2)
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture
def kernel_unwrap(monkeypatch):
    """The reference unwrap through its Pallas kernels where it takes
    them (interpret mode off the TPU)."""
    jax.clear_caches()
    monkeypatch.setattr(JU, "_PALLAS_CG", True)
    monkeypatch.setattr(JU, "_PALLAS_VCYCLE", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _both(dx, dy, w, **kw):
    wj = None if w is None else jnp.asarray(w)
    want = jax.vmap(lambda a, b: JU.phase_unwrap_prediff_mg(
        a, b, wj, kmax=6, coarse=4, precision=HIGHEST, **kw))(
            jnp.asarray(dx), jnp.asarray(dy))
    got = TU.phase_unwrap_prediff_mg(
        torch.from_numpy(dx), torch.from_numpy(dy),
        None if w is None else torch.from_numpy(w), kmax=6, coarse=4, **kw)
    return got, np.asarray(want)


SCHEDULES = {"default": None, "vv": ((4, 6), (1, "vv")),
             "mid_vv": ((4, 6), (2, 1), (1, "vv")),
             "cg_final": ((4, 3), (1, 2)), "coarse_only": ((4, 6),)}


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_unwrap_mg_schedules_match(sched, weighted):
    """Every schedule form, weighted and not, at 256^2 float32 (the
    coarse-only schedule is resized back to the full grid)."""
    dx, dy, w = _problem(256, 3)
    got, want = _both(dx, dy, w if weighted else None,
                      schedule=SCHEDULES[sched])
    assert got.shape == (2, 256, 256) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("final", ["v", "vv"])
def test_unwrap_mg_sides_the_factors_do_not_divide(final):
    """250^2, weighted: the V-branch's restriction drops the rows and
    columns past the last whole block, as the reference's block means
    do (the pre-smooth twin used to require whole blocks)."""
    dx, dy, w = _problem(250, 10)
    got, want = _both(dx, dy, w, schedule=((4, 6), (1, final)))
    assert got.shape == (2, 250, 250)
    _close(got.numpy(), want, 1e-4)


def test_vv_matches_kernel_reference(kernel_unwrap):
    """"vv" against the reference on its kernel route (presmooth, applyq
    and the coarse CG in interpret mode)."""
    dx, dy, w = _problem(256, 9)
    got, want = _both(dx, dy, w, schedule=((4, 6), (1, "vv")))
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("final", ["v", "vv"])
def test_unwrap_mg_float64_matches(final, weighted):
    dx, dy, w = (a.astype(np.float64) for a in _problem(128, 5))
    got, want = _both(dx, dy, w if weighted else None,
                      schedule=((4, 6), (1, final)))
    assert got.dtype == torch.float64
    _close(got.numpy(), want, 1e-10)


@pytest.mark.parametrize("mult", [2, 8])
def test_v_coarse_mult_matches(mult):
    dx, dy, w = _problem(256, 6)
    got, want = _both(dx, dy, w, schedule=((4, 6), (1, "vv")),
                      v_coarse_mult=mult)
    _close(got.numpy(), want, 1e-4)


def test_unweighted_defaults_match():
    """weight=None with the default schedule, as phase_unwrap_mg's
    gradient form; the unweighted phase_unwrap_mg stays one exact
    Poisson solve, as the reference's."""
    dx, dy, _ = _problem(256, 7)
    got, want = _both(dx, dy, None)
    _close(got.numpy(), want, 1e-4)
    psi = np.cumsum(np.cumsum(dx[0], 1), 0)[:, :128].astype(np.float64)
    np.testing.assert_allclose(
        TU.phase_unwrap_mg(torch.from_numpy(psi), None).numpy(),
        np.asarray(JU.phase_unwrap_mg(jnp.asarray(psi), None)), atol=1e-10)


@pytest.mark.parametrize("final,applyq", [("v", 1), ("vv", 3)])
def test_v_branch_launches(monkeypatch, final, applyq):
    """Routed as on the card (the gate read without its device
    condition, so the CPU runs the wrappers' twins): the pre-smooth runs
    once a call and Q p once for "v", three times for "vv" (each round's
    line search and the residual update between the rounds); the
    unweighted problem takes neither wrapper."""
    dx, dy, w = _problem(256, 8)
    monkeypatch.setattr(tvc, "vcycle_kernel_ok", lambda phi, w, cr: True)
    calls = {"presmooth": 0, "applyq": 0}
    for name in calls:
        orig = getattr(tvc, name)

        def spy(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(tvc, name, spy)
    TU.phase_unwrap_prediff_mg(torch.from_numpy(dx), torch.from_numpy(dy),
                               torch.from_numpy(w), kmax=6, coarse=4,
                               schedule=((4, 6), (1, final)))
    assert calls == {"presmooth": 1, "applyq": applyq}
    TU.phase_unwrap_prediff_mg(torch.from_numpy(dx), torch.from_numpy(dy),
                               None, kmax=6, coarse=4,
                               schedule=((4, 6), (1, final)))
    assert calls == {"presmooth": 1, "applyq": applyq}


def test_mg_schedule_knob_validation():
    """tests/test_unwrap.py's check: a bad unwrap_mg_final-style string
    raises a ValueError naming unwrap_mg_final; 1, "v" and "vv" run."""
    dx = torch.zeros((64, 63))
    dy = torch.zeros((63, 64))
    w = torch.ones((64, 64))
    with pytest.raises(ValueError, match="unwrap_mg_final"):
        TU.phase_unwrap_prediff_mg(dx, dy, w, schedule=((4, 2), (1, "cg")))
    for final in (1, "v", "vv"):
        out = TU.phase_unwrap_prediff_mg(dx, dy, w,
                                         schedule=((4, 2), (1, final)))
        assert out.shape == (64, 64)
        assert torch.equal(out, torch.zeros_like(out))


def _plane_psi(n=128):
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    psi0 = (yy + xx) / (4 * np.sqrt(2)) + 2 * np.sin(xx / 17.0)
    return (psi0 + np.pi) % (2 * np.pi) - np.pi, xx, yy


def test_api_parity_names_match():
    """phase_unwrap_ref[_prediff], solvePoisson[_precomped],
    precomp_Poissonscaling, applyQ and _wrapToPi against the
    reference's, float64, with and without a weight."""
    psi, xx, yy = _plane_psi()
    w = np.exp(-((xx - 64) ** 2 + (yy - 64) ** 2) / (0.3 * 128 ** 2))
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    for weight in (None, w):
        tw = None if weight is None else torch.from_numpy(weight)
        jw = None if weight is None else jnp.asarray(weight)
        _close(TU.phase_unwrap_ref(tp, tw, 20).numpy(),
               JU.phase_unwrap_ref(jp, jw, 20), 1e-10)
        dx, dy = np.diff(psi, axis=1), np.diff(psi, axis=0)
        _close(TU.phase_unwrap_ref_prediff(torch.from_numpy(dx),
                                           torch.from_numpy(dy), tw,
                                           20).numpy(),
               JU.phase_unwrap_ref_prediff(jnp.asarray(dx), jnp.asarray(dy),
                                           jw, 20), 1e-10)
    rho = np.random.default_rng(12).normal(size=(96, 80))
    trho, jrho = torch.from_numpy(rho), jnp.asarray(rho)
    _close(TU.solvePoisson(trho).numpy(), JU.solvePoisson(jrho), 1e-10)
    scale = TU.precomp_Poissonscaling(trho)
    _close(scale.numpy(), JU.precomp_Poissonscaling(jrho), 1e-12)
    _close(TU.solvePoisson_precomped(trho, scale).numpy(),
           JU.solvePoisson_precomped(jrho, jnp.asarray(scale.numpy())),
           1e-10)
    WWx = np.random.default_rng(13).uniform(size=(96, 79))
    WWy = np.random.default_rng(14).uniform(size=(95, 80))
    _close(TU.applyQ(trho, torch.from_numpy(WWx),
                     torch.from_numpy(WWy)).numpy(),
           JU.applyQ(jrho, jnp.asarray(WWx), jnp.asarray(WWy)), 1e-12)
    x = rho * 7
    np.testing.assert_allclose(TU._wrapToPi(torch.from_numpy(x)).numpy(),
                               np.asarray(JU._wrapToPi(jnp.asarray(x))),
                               atol=1e-12)
    for name in ("phase_unwrap_ref", "phase_unwrap_ref_prediff",
                 "solvePoisson", "solvePoisson_precomped",
                 "precomp_Poissonscaling", "applyQ", "phase_unwrap",
                 "phase_unwrap_mg", "phase_unwrap_prediff", "solve_poisson",
                 "weighted_lstsq_stack"):
        assert callable(getattr(tsolvers, name))
