"""Element sharding in the port (``pnp_tpu_torch.parallel.sharding`` and
the single driver's ``device_mesh``) against ``pnp_tpu``'s on the 8
virtual devices of tests/conftest.py, on the CPU.

The case is ``one_wall_case(41, 5)`` (252 dofs, 410 triangles: 8 shards
need 6 padded elements), built in code (tests/test_parallel.py's fixture
reads the absent reference tree); ``CG_AMG_SSOR``, which needs a shard
count that divides the element count in both packages, runs on
``one_wall_case(40, 5)`` (246 dofs, 400 triangles). Tolerances are
tests/test_parallel.py's own: rtol 1e-9 / atol 1e-12 for one fused step,
1e-8 / 1e-11 over three scan steps.

- ``pad_elements`` and ``shard_volume_tables`` equal the reference's on
  the same tables; the reference's padded tables carried in by
  ``interop.volume_tables`` equal the port's own; a rank holds its rows.
- ``build_pnp_system(device_mesh=8)``: one fused step and three scan
  steps against the reference's sharded build under ``BCGS_SSORk``,
  ``BCGS_NOPREC`` and ``CG_AMG_SSOR``, and the port's K = 8 against its
  K = 1 (``BCGS_SSORk`` and ``CG_AMG_SSOR``).
- 2 gloo ranks x 4 shards (``multiproc_smoke --task sharded``, started as
  tests/test_torch_distributed.py starts its ranks) against one process,
  the ranks' final fields bitwise equal, under ``BCGS_SSORk`` and
  ``CG_AMG_SSOR``.
- A shard count that the ranks do not divide raises; so does, under
  ``CG_AMG_SSOR``, one that does not divide the element count
  (``ValueError`` in the port; the reference's build fails there too).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import rect_mesh
from pnp_tpu.parallel import sharding as JS
from pnp_tpu.workloads.instationary_pnp_from_pb import (
    build_pnp_system as j_build)

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.fem import assembly as FA
from pnp_tpu_torch.fem.geometry import build_volume_tables
from pnp_tpu_torch.operators import volume as V
from pnp_tpu_torch.parallel import distributed as PD
from pnp_tpu_torch.parallel import sharding as S
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = (41, 5)
AMG_CASE = (40, 5)                          # E = 400: K = 8 divides it
K = 8
STEP_TOL = dict(rtol=1e-9, atol=1e-12)      # tests/test_parallel.py
SCAN_TOL = dict(rtol=1e-8, atol=1e-11)
RANKS_TOL = 1e-9                            # of max + 1, as chip_smoke.py
RANK_STEPS = 3
LAUNCH_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            pytest.skip(f"cannot bind a localhost port: {e}")
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def case():
    return problems.one_wall_case(*CASE)


@pytest.fixture(scope="module")
def amg_case():
    return problems.one_wall_case(*AMG_CASE)


def _launch_ranks(tmp_path_factory, case, solver):
    """2 gloo ranks x 4 shards of the sharded driver under ``solver``,
    started at once (the tests before them run meanwhile); a function
    that waits for them and returns (exit code, output, the coordinator's
    .npz path, the output directory)."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = tmp / "ranks.npz"
    cmd = [sys.executable, "-m", "pnp_tpu_torch.tools.multiproc_smoke",
           "--procs", "2", "--backend", "gloo", "--device", "cpu",
           "--port", str(_free_port()), "--timeout", str(LAUNCH_TIMEOUT),
           "--task", "sharded", "--shards", str(K), "--nx", str(case[0]),
           "--ny", str(case[1]), "--steps", str(RANK_STEPS),
           "--solver", solver, "--output-dir", str(tmp / "out"),
           "--out", str(out)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        text, _ = proc.communicate(timeout=LAUNCH_TIMEOUT + 60)
        return proc.returncode, text, out, tmp / "out"
    return wait


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _launch_ranks(tmp_path_factory, CASE, "BCGS_SSORk")


@pytest.fixture(scope="module")
def amg_ranks(tmp_path_factory):
    return _launch_ranks(tmp_path_factory, AMG_CASE, "CG_AMG_SSOR")


def test_pad_and_shard_tables_match_reference(case, ranks, amg_ranks):
    """The port's padding and placement equal the reference's on the same
    tables: padded rows zero (dof 0), every other row in order; the
    reference's sharded tables carried in equal the port's; rank 1 of 2
    holds the second half of the padded rows."""
    _, tspace = case
    jvt = j_tables(JFS(rect_mesh(CASE[0], CASE[1], 5.0, 0.5), 1), 2)
    E = jvt.dofmap.shape[0]
    assert S._pad_amount(E, K) == JS._pad_amount(E, K) == 6
    for name in ("gradphi", "qw", "qy", "dofmap"):
        a = np.asarray(getattr(jvt, name))
        np.testing.assert_array_equal(S.pad_elements(a, E + 6),
                                      JS.pad_elements(a, E + 6))
    jsvt = JS.shard_volume_tables(jvt, JS.make_device_mesh(K))
    mesh = S.make_device_mesh(K, device="cpu")
    assert (mesh.n_shards, mesh.K_local, mesh.ranked) == (K, K, False)
    tvt = S.shard_volume_tables(build_volume_tables(tspace, 2), mesh)
    carried = interop.volume_tables(jsvt, "cpu", mesh)
    assert isinstance(tvt.dofmap, S.ShardedDofmap)
    assert isinstance(carried.dofmap, S.ShardedDofmap)
    for name in ("shape", "gradphi", "qw", "qy", "dofmap"):
        want = np.asarray(getattr(jsvt, name))
        np.testing.assert_allclose(getattr(tvt, name).numpy(), want,
                                   rtol=1e-15, atol=0, err_msg=name)
        np.testing.assert_array_equal(getattr(carried, name).numpy(), want,
                                      err_msg=name)
    assert float(tvt.qw[E:].abs().max()) == 0.0
    assert int(tvt.dofmap[E:].abs().max()) == 0
    with pytest.raises(ValueError, match="padded"):
        interop.volume_tables(jvt, "cpu", mesh)
    rank1 = PD.RankLayout(K, 2, 1, torch.device("cpu"), "gloo")
    half = S.shard_volume_tables(tvt, rank1)
    E_s = (E + 6) // K
    assert half.dofmap.mesh is rank1 and half.num_elements == 4 * E_s
    for name in ("gradphi", "qw", "qy", "dofmap"):
        assert torch.equal(getattr(half, name),
                           getattr(tvt, name)[4 * E_s:]), name


def test_scatters_sum_the_shards(case):
    """The reduction point: a scatter over sharded tables sums the shards'
    partials (padded rows add exactly zero); the element forms on padded
    rows give exact zeros, never NaN."""
    _, tspace = case
    vt = build_volume_tables(tspace, 2)
    svt = S.shard_volume_tables(vt, S.make_device_mesh(K, "cpu"))
    n = tspace.ndof
    E = vt.dofmap.shape[0]
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal((2, n)))
    A = V.laplace_jacobian_el(vt)
    A_s = V.laplace_jacobian_el(svt)
    assert torch.equal(A_s[E:], torch.zeros_like(A_s[E:]))
    gphi = torch.zeros(A_s.shape[0], vt.qw.shape[1], 2, dtype=A.dtype)
    J = V.drift_diffusion_jacobian_el(gphi, svt, 1.0, False, 1.0)
    assert bool(torch.isfinite(J).all()) and float(J[E:].abs().max()) == 0
    pairs = (
        (FA.spmv(A, u[0], vt.dofmap, n), FA.spmv(A_s, u[0], svt.dofmap, n)),
        (FA.spmv_batched(A.expand(2, *A.shape), u, vt.dofmap, n),
         FA.spmv_batched(A_s.expand(2, *A_s.shape), u, svt.dofmap, n)),
        (FA.diagonal(A, vt.dofmap, n), FA.diagonal(A_s, svt.dofmap, n)))
    for want, got in pairs:
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    assert S.replicate(S.make_device_mesh(K, "cpu"), u) is u


@pytest.mark.parametrize("solver", ["BCGS_SSORk", "BCGS_NOPREC",
                                    "CG_AMG_SSOR"])
def test_sharded_step_matches_reference(case, amg_case, solver):
    """``build_pnp_system(device_mesh=8)`` against the reference's sharded
    build on 8 virtual devices, from a zero PB field: one fused step and
    three scan steps (tests/test_parallel.py's tolerances). Both take the
    Krylov tier (no dense tier, no block-RAS on sharded tables);
    ``CG_AMG_SSOR`` on the case whose element count 8 divides, its
    aggregations of the whole dof map, its element blocks sharded."""
    assert len(jax.devices()) >= K
    amg = solver == "CG_AMG_SSOR"
    nx, ny = AMG_CASE if amg else CASE
    tsys, tspace = amg_case if amg else case
    tsys = dataclasses.replace(tsys, linearSolver=solver)
    jsys = j_build(jax_sysparams(tsys), JFS(rect_mesh(nx, ny, 5.0, 0.5), 1),
                   device_mesh=JS.make_device_mesh(K),
                   pb_field=jnp.zeros(tspace.ndof))
    tsys_ = W.build_pnp_system(tsys, tspace, device_mesh=K,
                               pb_field=np.zeros(tspace.ndof), device="cpu")
    assert tsys_.poisson_tier == "krylov" and tsys_.factor_kind is None
    assert tsys_.species_factor is None and jsys.species_factor is None
    s1 = jsys.fused_step(jsys.uphi0, jsys.ucp0, jsys.ucm0)
    t1 = tsys_.fused_step(tsys_.uphi0, tsys_.ucp0, tsys_.ucm0)
    for a, b in zip(s1, t1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **STEP_TOL)
    o1 = jsys.scan_steps(s1, 3)
    o2 = tsys_.scan_steps(t1, 3)
    for a, b in zip(o1, o2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **SCAN_TOL)


def test_k8_matches_k1(case):
    """The port's K = 8 against its K = 1 (one shard: no padding, the same
    Krylov tier), a fused step and three scan steps."""
    tsys, tspace = case
    pb = np.zeros(tspace.ndof)
    one, eight = (W.build_pnp_system(tsys, tspace, device_mesh=k,
                                     pb_field=pb, device="cpu")
                  for k in (1, K))
    s1 = one.fused_step(one.uphi0, one.ucp0, one.ucm0)
    s8 = eight.fused_step(eight.uphi0, eight.ucp0, eight.ucm0)
    for a, b in zip(s1, s8):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **STEP_TOL)
    for a, b in zip(one.scan_steps(s1, 3), eight.scan_steps(s8, 3)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **SCAN_TOL)


def test_amg_k8_matches_k1(amg_case):
    """The port's K = 8 against its K = 1 under ``CG_AMG_SSOR``: the same
    aggregations, the coarse matrix summed from 8 shards' blocks; a fused
    step and three scan steps."""
    tsys, tspace = amg_case
    tsys = dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR")
    pb = np.zeros(tspace.ndof)
    one, eight = (W.build_pnp_system(tsys, tspace, device_mesh=k,
                                     pb_field=pb, device="cpu")
                  for k in (1, K))
    assert eight.poisson_tier == "krylov"
    s1 = one.fused_step(one.uphi0, one.ucp0, one.ucm0)
    s8 = eight.fused_step(eight.uphi0, eight.ucp0, eight.ucm0)
    for a, b in zip(s1, s8):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **STEP_TOL)
    for a, b in zip(one.scan_steps(s1, 3), eight.scan_steps(s8, 3)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **SCAN_TOL)


def _check_ranks(launched, case, solver):
    rc, text, out, out_dir = launched()
    assert rc == 0, text[-4000:]
    got = np.load(out)
    tsys, tspace = case
    tsys = dataclasses.replace(tsys, linearSolver=solver)
    one = W.run_instationary_pnp_from_pb(tsys, tspace, n_steps=RANK_STEPS,
                                         device_mesh=K, device="cpu")
    assert (int(got["n_ranks"]), int(got["n_shards"])) == (2, K)
    assert str(got["poisson_tier"]) == "krylov"
    assert int(got["pb_newton_iterations"]) == one.pb_newton_iterations
    assert got["poisson_iterations"].tolist() == one.poisson_iterations
    assert got["species_iterations"].tolist() == one.species_iterations
    for name in ("phi", "cp", "cm"):
        want = getattr(one, name).numpy()
        err = np.abs(got[name] - want).max() / (np.abs(want).max() + 1.0)
        assert err <= RANKS_TOL, (name, err)
    for (_, *a), b in zip(one.current_history, zip(got["ip"], got["im"])):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=0, atol=RANKS_TOL)
    fields = got["rank_fields"]
    assert fields.shape == (2, 3, tspace.ndof)
    assert np.array_equal(fields[0], fields[1])
    rows = np.loadtxt(out_dir / "current.dat")
    assert rows.shape == (RANK_STEPS, 1 + 2 * tsys.n_surfaces)


def test_ranks_match_one_process(case, ranks):
    """2 gloo ranks x 4 shards against one process at K = 8 (the run with
    its own phase A, RANK_STEPS steps): fields and currents to RANKS_TOL
    of max + 1, the same counts, the ranks' final fields bitwise equal,
    the outputs written once."""
    _check_ranks(ranks, case, "BCGS_SSORk")


def test_amg_ranks_match_one_process(amg_case, amg_ranks):
    """As above under ``CG_AMG_SSOR`` (``multiproc_smoke --solver``): each
    rank's coarse matrices the all-reduced sum of its shards' blocks."""
    _check_ranks(amg_ranks, amg_case, "CG_AMG_SSOR")


def test_undivided_shards_and_amg_raise(case, monkeypatch):
    """Under 2 ranks (the group faked: building a layout needs no
    collective) 3 shards raise, None means one a rank; ``CG_AMG_SSOR`` on
    sharded tables whose element count (410) 8 does not divide raises
    ValueError before any table is padded, and the reference's sharded
    build fails there too, at its first step (its aggregation context
    holds the unpadded dof map, its blocks are padded)."""
    tsys, tspace = case
    amg = dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR")
    with pytest.raises(ValueError, match="divides the element count"):
        W.build_pnp_system(amg, tspace, device_mesh=K,
                           pb_field=np.zeros(tspace.ndof), device="cpu")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jsys = j_build(jax_sysparams(amg),
                       JFS(rect_mesh(CASE[0], CASE[1], 5.0, 0.5), 1),
                       device_mesh=JS.make_device_mesh(K),
                       pb_field=jnp.zeros(tspace.ndof))
        jsys.fused_step(jsys.uphi0, jsys.ucp0, jsys.ucm0)
    for name, value in (("is_initialized", True), ("get_world_size", 2),
                        ("get_rank", 1), ("get_backend", "gloo")):
        monkeypatch.setattr(PD.dist, name, lambda v=value: v)
    with pytest.raises(ValueError, match="do not divide"):
        S.make_device_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        W.build_pnp_system(tsys, tspace, device_mesh=3,
                           pb_field=np.zeros(tspace.ndof), device="cpu")
    lay = S.make_device_mesh(device="cpu")
    assert (lay.n_shards, lay.K_local, lay.rank, lay.ranked) == (2, 1, 1,
                                                                 True)
