"""The one-level Schwarz Poisson's iteration-count tail (the Poisson
operator the owner-partitioned driver runs over more than one rank), held
in both packages on the same states, on the CPU.

The port's batch-axis driver is forced onto one-level Schwarz
(``TWO_LEVEL_DOFS`` above the case) and records every step's state
(``record_states=True``); the reference's driver takes the same branch
with ``build_dist_context(host_tables=True)``
(pnp_tpu/parallel/dist.py:349, pnp_tpu/workloads/distributed_pnp.py:224)
on the 8 virtual devices of tests/conftest.py. Each step's 1e-10 re-solve
then runs in both packages from the recorded state, K = 8 shards. What is
asserted is what stays put from one build of either package to another:

- the two packages' least counts agree within 10 %;
- the fields agree where both converge, to FIELD_TOL of max + 1;
- the port, given the reference's f32 local inverses, converges on every
  state.

The tail itself (a few solves in each package that run many times longer,
on different solves in the two) is printed, per solve and per package,
and never asserted: the rounding of a whole BiCGSTAB run decides which
solves part, so a new library version or thread count moves it. The
counts measured so far are in ROADMAP section 3."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.operators import volume as JV
from pnp_tpu.parallel import dist as JDIST
from pnp_tpu.parallel.sharding import make_device_mesh
from pnp_tpu.solvers import schwarz as JSW
from pnp_tpu.workloads import distributed_pnp as JDP
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import problems
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers import schwarz as SW
from pnp_tpu_torch.solvers.krylov import bicgstab
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads.common import make_scalar_context as t_context

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

K = 8
FIELD_TOL = 1e-8       # the 1e-10 re-solves of both, of max + 1


def slack(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


def solves(nx, ny, steps, monkeypatch):
    """The port's run (one-level, presolved, a species factor every 4
    steps), then each step's Poisson re-solve again in both packages from
    the recorded states: (port counts, reference counts, field
    differences where both converged, the run, the reference system, the
    states of each solve)."""
    tsys, tspace = problems.pore_case(nx, ny)
    monkeypatch.setattr(TD, "TWO_LEVEL_DOFS", 10 ** 9)
    run = TD.run_distributed_pnp_from_pb(
        tsys, tspace, K, n_steps=steps, presolve_potential=True,
        ras_refresh_every=4, record_states=True, device="cpu")
    assert run.system.poisson_tier == "schwarz"
    monkeypatch.setattr(JDP, "build_dist_context", functools.partial(
        JDIST.build_dist_context, host_tables=True))
    jsys = JDP.build_dist_pnp_system(
        jax_sysparams(tsys), JFS(pore_without_dna_mesh(nx, ny), 1),
        make_device_mesh(K),
        pb_field=jnp.asarray(run.system.to_global(run.system.pb)))
    jctx, tsys_, tctx = jsys.ctx, run.system, run.system.ctx
    cap = tsys.linearSolverIterations
    port, ref, diffs, inputs = [], [], [], []
    for i in range(steps):
        # step i re-solved Poisson from the potential before it and the
        # species after it
        phi = run.states[i][0]
        cp, cm = run.states[i + 1][1], run.states[i + 1][2]
        inputs.append((phi, cp, cm))
        tphi, tk, ok = tsys_.poisson_solve(
            torch.as_tensor(tctx.partition(phi)),
            torch.stack([torch.as_tensor(tctx.partition(c))
                         for c in (cp, cm)]))
        jphi, jk = jsys.poisson_solve(
            jctx.put_global(jnp.asarray(jctx.partition(phi))),
            jctx.put_global(jnp.asarray(np.stack(
                [jctx.partition(c) for c in (cp, cm)])), axis=1))
        port.append(tk)
        ref.append(int(jk))
        if ok and int(jk) < cap:
            diffs.append(slack(tsys_.to_global(tphi),
                               jctx.unpartition(np.asarray(jphi))))
    print(f"pore_case({nx}, {ny}), K = {K}, one-level Schwarz, per solve: "
          f"port {port}, reference {ref}; fields where both converged "
          f"{max(diffs):.2e} (tol {FIELD_TOL:g})")
    return port, ref, diffs, run, jsys, inputs


def _least_counts_agree(port, ref):
    """Both packages' least counts (the body, which a tail solve cannot
    move) agree within 10 %; prints each package's worst solve."""
    lp, lr = min(port), min(ref)
    print(f"least counts port {lp}, reference {lr}; worst port "
          f"{max(port)} (solve {int(np.argmax(port))}), reference "
          f"{max(ref)} (solve {int(np.argmax(ref))})")
    assert abs(lp - lr) <= 0.1 * lr, (port, ref)


def test_one_level_tail_both_packages(monkeypatch):
    """``pore_case(80, 44)`` (3,105 dofs), 8 presolved steps: the least
    counts agree within 10 % and the fields agree where both converge.
    Then the port solves every step's state with the reference's f32
    local inverses carried in, and each of those solves converges."""
    port, ref, diffs, run, jsys, inputs = solves(80, 44, 8, monkeypatch)
    _least_counts_agree(port, ref)
    assert max(diffs) <= FIELD_TOL

    # the reference's f32 local inverses in the port's solve of each state
    tsys, tspace = problems.pore_case(80, 44)
    tctx, jctx = run.system.ctx, jsys.ctx
    jc = j_context(jsys.sys, jsys.space, 0, 3)
    jvt = JDP.partition_volume_tables(jctx, jc.vt)
    jfree = jnp.asarray(jctx.partition(np.asarray(jc.free).astype(np.int8))
                        .astype(bool) & np.asarray(jctx.pad_mask_flat()))
    jloc = JSW.build_local_matrices(
        jctx, JV.poisson_jacobian_el(jvt, tsys.cylindrical, tsys.pi), jfree)
    jinv = np.array(JSW.invert_local_matrices(jctx, jloc))
    tc = t_context(tsys, tspace, 0, 3, device="cpu")
    tvt = TD.partition_volume_tables(tctx, tc.vt)
    tfree = torch.as_tensor(
        tctx.partition(tc.free.numpy().astype(np.int8)).astype(bool)
        & tctx.pad_mask_flat())
    A = TV.poisson_jacobian_el(tvt, tsys.cylindrical, tsys.pi)
    tinv = SW.invert_local_matrices(
        tctx, SW.build_local_matrices(tctx, A, tfree)).numpy()
    op = tctx.make_constrained_operator(A, tfree)
    M = SW.make_ras_inv_precond(tctx, torch.as_tensor(jinv))
    flux = torch.as_tensor(tctx.partition(tc.flux_vector.numpy()))
    counts, converged = [], []
    for state in inputs:
        phi, cp, cm = (torch.as_tensor(tctx.partition(v)) for v in state)
        r_el = TV.poisson_residual_el(
            tctx.gather_elem(phi), tctx.gather_elem(cp),
            tctx.gather_elem(cm), tvt, tsys.l_b, tsys.cylindrical, tsys.pi)
        r = torch.where(tfree, tctx.scatter_elem(r_el) + flux, 0.0)
        res = bicgstab(op, r, torch.zeros_like(r), M, 1e-10,
                       tsys.linearSolverIterations)
        counts.append(res.iterations)
        converged.append(res.converged)
    print(f"f32 local inverses port vs reference "
          f"{np.abs(tinv - jinv).max() / np.abs(jinv).max():.1e} of their "
          f"largest entry; the port with the reference's inverses, per "
          f"solve: {counts}")
    assert all(converged), (counts, converged)


@pytest.mark.slow
def test_one_level_tail_both_packages_full_size(monkeypatch):
    """``pore_case(160, 88)`` (12,097 dofs, the size of ``chip_smoke.py``'s
    ``[procs gloo]``), 8 presolved steps: the least counts agree within
    10 % and the fields agree where both converge; the tails are printed.
    Marked slow: it takes minutes on a CPU, more than a tier-1 file may
    take."""
    port, ref, diffs, *_ = solves(160, 88, 8, monkeypatch)
    _least_counts_agree(port, ref)
    assert max(diffs) <= FIELD_TOL
