"""P2 and P3 through the port's production driver, held against the
reference package on the CPU on ``one_wall_case`` (the degree-2/3 branch
of the dense tier's stage matrix, ``use_fast_dense`` off, runs here):
``solve_pb`` with the reference's Newton count and field (1e-10), three
presolved dense-tier steps (1e-10), ``solve_pb`` at P2 above 8,192 dofs
on the block-RAS tier (the Debye-Hueckel profile), and P2 through the
owner-partitioned driver at K = 4 against the single-device driver
(1e-8). Models: tests/test_higher_order.py,
tests/test_dist_driver.py:152-166."""

import dataclasses

import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import rect_mesh as j_rect
from pnp_tpu.postprocess.ionflux import calc_ion_flux as j_ion_flux
from pnp_tpu.workloads import instationary_pnp_from_pb as JW
from pnp_tpu.workloads.pb import solve_pb as j_solve_pb

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.fem.space import FunctionSpace as TFS
from pnp_tpu_torch.meshio.structured import rect_mesh as t_rect
from pnp_tpu_torch.postprocess.ionflux import calc_ion_flux
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW
from pnp_tpu_torch.workloads import pb as TPB
from pnp_tpu_torch.workloads.pb import solve_pb as t_solve_pb

from test_torch_host import jax_sysparams

torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def pair(degree, nx=40, ny=4):
    tsys, tspace = problems.one_wall_case(nx, ny, degree)
    return tsys, tspace, jax_sysparams(tsys), JFS(j_rect(nx, ny, 5.0, 0.5),
                                                   degree)


@pytest.mark.parametrize("degree", [2, 3])
def test_solve_pb_matches_reference(degree):
    tsys, tspace, jsys, jspace = pair(degree)
    np.testing.assert_array_equal(tspace.dofmap, np.asarray(jspace.dofmap))
    rt, rj = t_solve_pb(tsys, tspace, device="cpu"), j_solve_pb(jsys, jspace)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) > 0
    assert rel(rt.u, rj.u) <= 1e-10, rel(rt.u, rj.u)


@pytest.mark.parametrize("degree", [2, 3])
def test_dense_tier_presolved_steps_match_reference(degree):
    """The dense tier at P2/P3: the general stage matrix (element blocks
    assembled densely), f32 stage inverses and f64 refinement; the same PB
    field in both packages, ``poisson_solve`` once, then three steps:
    fields and currents to 1e-10, the same refinement counts."""
    tsys, tspace, jsys, jspace = pair(degree)
    j = JW.build_pnp_system(jsys, jspace)
    t = TW.build_pnp_system(tsys, tspace, pb_field=interop.field(j.pb),
                            device="cpu")
    assert (t.factor_kind, t.poisson_tier) == ("dense", "dense")
    assert tuple(t.species_dense_f32(t.uphi0).shape) == (2, tspace.ndof,
                                                         tspace.ndof)
    js = (j.uphi0, j.ucp0, j.ucm0)
    js = (j.poisson_solve(*js)[0], js[1], js[2])
    ts = interop.state(*js)
    for _ in range(3):
        jcp, jcm, jk = j.species_step(*js)
        tcp, tcm, tk = t.species_step(*ts)
        assert tk == int(jk)
        js = (j.poisson_solve(js[0], jcp, jcm)[0], jcp, jcm)
        ts = (t.poisson_solve(ts[0], tcp, tcm)[0], tcp, tcm)
        for a, b in zip(ts, js):
            assert rel(a, b) <= 1e-10, rel(a, b)
        for a, b in zip(calc_ion_flux(t.ionflux_tables, *ts),
                        j_ion_flux(j.ionflux_tables, *js)):
            assert rel(a, b) <= 1e-10


def test_p2_solve_pb_on_the_block_ras_tier(monkeypatch):
    """A wall mesh at P2 with 8,405 dofs, above the dense tier's 8,192:
    the PB Newton runs BiCGSTAB under block-RAS with edge dofs in the
    blocks (each Jacobian's local inverses built by kernel 1's plain
    version here), and the field matches the Debye-Hueckel profile to
    1e-4 (measured 1.8e-7), as the reference's own test asks of it."""
    flux = 1e-3
    tsys = problems.one_wall_sysparams()
    tsys.surfaces[0] = dataclasses.replace(tsys.surfaces[0], coulombFlux=flux)
    tspace = TFS(t_rect(102, 20, 5.0, 0.5), 2)
    assert tspace.ndof == 8405
    builds = []
    real = TPB.BR.build_local_inverses
    monkeypatch.setattr(TPB.BR, "build_local_inverses",
                        lambda ctx, A_el, free: builds.append(ctx.K)
                        or real(ctx, A_el, free))
    rt = t_solve_pb(tsys, tspace, device="cpu")
    assert rt.converged and rt.iterations > 0
    assert builds and len(builds) == rt.jacobian_builds and builds[0] > 1
    kappa = np.sqrt(8 * np.pi * tsys.l_b * tsys.c0)
    x = tspace.dof_coords[:, 0]
    want = -(flux / kappa) * np.sinh(kappa * (5.0 - x)) / np.cosh(kappa * 5.0)
    err = np.linalg.norm(rt.u.numpy() - want) / np.linalg.norm(want)
    assert err < 1e-4, err


def test_p2_distributed_matches_single_device():
    """P2 through the owner-partitioned context at K = 4 (edge dofs owned
    and exchanged across shards): 2 steps against the single-device
    driver, fields and currents to 1e-8."""
    tsys, tspace = problems.one_wall_case(40, 4, 2)
    dist = TD.run_distributed_pnp_from_pb(tsys, tspace, 4, n_steps=2,
                                          device="cpu")
    single = TW.run_instationary_pnp_from_pb(tsys, tspace, n_steps=2,
                                             device="cpu")
    assert dist.system.ctx.n == 6
    for n in ("phi", "cp", "cm"):
        diff = np.abs(getattr(dist, n) - getattr(single, n).numpy()).max()
        assert diff <= 1e-8, (n, diff)
    for (_, *xs), (_, *ys) in zip(dist.current_history,
                                  single.current_history):
        for x, y in zip(xs, ys):
            assert np.abs(x - y).max() <= 1e-8
