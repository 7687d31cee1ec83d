"""Centralized physics-derived defaults (counterpart of
pygpa_tpu/config.py; every value is copied from the reference package,
and a test holds the two equal field by field)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GPAConfig:
    # Gaussian lock-in window width (px); pipelines usually derive
    # sigma = ceil(1 / min |k|) instead.
    sigma: float = 22.0
    # WFR k-window: kw = mean|k| / kw_scale, kstep = kw / ksteps.
    kw_scale: float = 2.5
    ksteps: int = 3
    # Phase-unwrap CG iteration tiers.
    unwrap_kmax: int = 100
    unwrap_kmax_reconstruct: int = 10
    # coarsest-level CG iterations of the multigrid unwrap
    unwrap_kmax_mg: int = 6
    # CG iterations at the coarse//2 mid level of the default multigrid
    # schedule: "auto" skips the level when the mid grid is >= 1024 px
    # and keeps 1 iteration on smaller images; an int forces that many
    # iterations everywhere (0 = always skip).
    unwrap_mg_mid: object = "auto"
    # finest-level strategy of the multigrid unwrap: 1 = one
    # full-resolution DCT-preconditioned CG step, "v"/"vv" = smooth /
    # coarse-correct / smooth V-branch rounds.
    unwrap_mg_final: object = "v"
    # CG iterations of the V-branch's coarse-grid correction solve
    # (None = inherit kmax).
    unwrap_mg_v_kmax: object = 4
    unwrap_kmax_iterate: int = 25
    unwrap_kmax_final: int = 200
    # Zoom-window tail cut (-ln G at the window edge) of the production
    # f32 pipeline sweep (make_displacement_extractor).
    pipeline_gauss_cut: float = 7.0
    # The sweep emits the reconstruction prologue (dudx, dudy, wnorm)
    # directly instead of phase/weight planes.
    pipeline_fused_uv: bool = True
    # Graphene lattice constant in nm.
    a_0: float = 0.246
    # Poisson ratio for heterostrain decompositions.
    poisson_ratio: float = 0.16
    # Wiener deconvolution regularization and reflect-pad width.
    wiener_balance: float = 5000.0
    wiener_pad: int = 20


DEFAULTS = GPAConfig()
