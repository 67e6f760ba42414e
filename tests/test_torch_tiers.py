"""The Poisson tier and the species path that ``choose_tiers`` picks for
``build_pnp_system``, against what the built system reports, on the
488-node pore case (P2 on the same mesh for the dense tier's general
drift form). Every system is built from one PB field."""

import dataclasses

import pytest
import torch

from pnp_tpu_torch import problems
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.solvers import direct as TD
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import (PoissonTier,
                                                              SpeciesPath)
from pnp_tpu_torch.workloads.pb import solve_pb

torch.set_num_threads(1)

RAS = dict(dense_poisson_threshold=0, ras_block_size=64)
NDOF = 488

# id: (build keywords, selection, built (poisson_tier, factor_kind)); the
# keywords "degree", "substeps", "solver", "max_inv" and "bad_inverse" set
# the space's degree, a tableau whose stage diagonals differ, the solver
# variant, POISSON_INV_MAX_DOFS and a very-large inverse that fails its
# probe
CASES = {
    "dense-p1": (
        {}, (PoissonTier("dense"), SpeciesPath("dense", rank1=True)),
        ("dense", "dense")),
    "dense-p2": (
        {"degree": 2}, (PoissonTier("dense"), SpeciesPath("dense")),
        ("dense", "dense")),
    "dense-substeps": (
        {"substeps": True}, (PoissonTier("dense"), SpeciesPath("krylov")),
        ("dense", None)),
    "inverse": (
        RAS, (PoissonTier("inverse"), SpeciesPath("ras")),
        ("inverse", "ras")),
    "inverse-two-level": (
        dict(RAS, species_two_level=True),
        (PoissonTier("inverse"), SpeciesPath("ras", two_level=True)),
        ("inverse", "ras")),
    "inverse-mid-species": (
        dict(RAS, species_inv_threshold=NDOF),
        (PoissonTier("inverse"), SpeciesPath("ras", mid=True)),
        ("inverse", "ras")),
    "inverse-substeps": (
        dict(RAS, substeps=True, species_two_level=True),
        (PoissonTier("inverse"), SpeciesPath("ras_stage")),
        ("inverse", None)),
    "inverse_large": (
        dict(RAS, max_inv=0),
        (PoissonTier("inverse_large"), SpeciesPath("ras")),
        ("inverse_large", "ras")),
    "inverse_large-failed-probe": (
        dict(RAS, max_inv=0, bad_inverse=True),
        (PoissonTier("inverse_large"), SpeciesPath("ras")),
        ("ras", "ras")),
    "ras": (
        dict(RAS, poisson_inv_threshold=0),
        (PoissonTier("ras"), SpeciesPath("ras")), ("ras", "ras")),
    "ras-substeps": (
        dict(RAS, poisson_inv_threshold=0, substeps=True),
        (PoissonTier("ras"), SpeciesPath("ras_stage")), ("ras", None)),
    "krylov-variant": (
        dict(RAS, solver="BCGS_Jacobi"),
        (PoissonTier("krylov"), SpeciesPath("krylov")), ("krylov", None)),
    "krylov-amg": (
        dict(RAS, solver="CG_AMG_SSOR"),
        (PoissonTier("krylov", amg=True), SpeciesPath("krylov")),
        ("krylov", None)),
    "device-mesh": (
        {"device_mesh": 2}, (PoissonTier("krylov"), SpeciesPath("krylov")),
        ("krylov", None)),
}


@pytest.fixture(scope="module")
def pb_fields():
    """The PB field of the P1 and the P2 space, solved once each."""
    out = {}
    for degree in (1, 2):
        sysp, space = problems.pore_case(30, 17, degree)
        out[degree] = solve_pb(sysp, space, device="cpu").u
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_tier_selection(case, pb_fields, monkeypatch):
    """``choose_tiers`` gives the listed choices for the case's inputs, and
    the system built from them reports its Poisson tier and factor kind
    (the failed very-large probe falls back to "ras" at setup)."""
    kw, want, (built_tier, built_kind) = CASES[case]
    kw = dict(kw)
    degree = kw.pop("degree", 1)
    sysp, space = problems.pore_case(30, 17, degree)
    sysp = dataclasses.replace(sysp,
                               linearSolver=kw.pop("solver", "BCGS_SSORk"))
    substeps = kw.pop("substeps", False)
    if substeps:
        kw["tableau"] = problems.substeps_tableau()
    monkeypatch.setattr(TW, "POISSON_INV_MAX_DOFS",
                        kw.pop("max_inv", TW.POISSON_INV_MAX_DOFS))
    if kw.pop("bad_inverse", False):
        real = TD.K.gj_inverse
        # kernel 1 on the very-large tier's call (no equilibration of its
        # own) scaled so that its refinement no longer contracts
        monkeypatch.setattr(TD.K, "gj_inverse", lambda A, equilibrate=True: (
            real(A, equilibrate) if equilibrate else real(A, False) / 3.0))

    got = TW.choose_tiers(
        space.ndof, sysp.linearSolver, "device_mesh" in kw, not substeps,
        degree, kw.get("dense_poisson_threshold", 8192),
        kw.get("poisson_inv_threshold", 49152),
        kw.get("species_inv_threshold", 0),
        kw.get("species_two_level", False))
    assert got == want

    system = TW.build_pnp_system(sysp, space, pb_field=pb_fields[degree],
                                 device="cpu", **kw)
    assert system.poisson_tier == built_tier
    assert system.factor_kind == built_kind
    assert system.mid_species == want[1].mid
    assert (system.species_factor is None) == (built_kind is None)
    assert (system.block_context is None) == (
        want[1].name not in ("ras", "ras_stage"))
