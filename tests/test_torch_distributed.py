"""The port's rank path (``pnp_tpu_torch.parallel.distributed`` and the
multi-process mode of the owner-partitioned driver) on the CPU: two
``gloo`` ranks on localhost, launched by
``python -m pnp_tpu_torch.tools.multiproc_smoke`` (the workers import
torch and the port only; this process runs the references).

- ``initialize_distributed``: arguments, torchrun's variables, False for
  one process or no address, the backend rule; ``global_device_mesh``
  with and without a group, a P that does not divide K raising.
- The exchange at K = 4 on ``rect_mesh(24, 16)`` against the batch-axis
  ``DistContext``: forward, backward, element gather and scatter, the
  env-element gather and the Schwarz local matrices it assembles exactly
  equal (data movement only); the SpMV and the reduced dots to 1e-14.
- The driver on ``one_wall_case(40, 4)``, 2 ranks x 2 shards, 4 presolved
  steps, against the port's batch-axis driver at K = 4 and ``pnp_tpu``'s
  distributed driver on 4 of the virtual devices of tests/conftest.py:
  fields and currents to 1e-8 (measured 1e-15); current.dat written once,
  equal to the batch-axis run's; checkpoints across the two forms; the
  tier rule (one-level Schwarz over ranks whatever ``TWO_LEVEL_DOFS``); a
  contraction-probe failure on rank 1 alone raising on both ranks.

Skips only where no localhost port can be bound (tests/test_multiprocess.py
does the same)."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import rect_mesh
from pnp_tpu.parallel.sharding import make_device_mesh
from pnp_tpu.workloads import distributed_pnp as JD

from pnp_tpu_torch import problems
from pnp_tpu_torch.parallel import distributed as PD
from pnp_tpu_torch.parallel.dist import build_dist_context
from pnp_tpu_torch.solvers import schwarz as SW
from pnp_tpu_torch.tools import multiproc_smoke as MS
from pnp_tpu_torch.workloads import distributed_pnp as TD

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
N_STEPS = 4
ATOL = 1e-8            # as tests/test_torch_dist_driver.py
LAUNCH_TIMEOUT = 240   # seconds a launch may take; measured 9-20 here


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            pytest.skip(f"cannot bind a localhost port: {e}")
        return s.getsockname()[1]


def ranks(*args, procs: int = 2):
    """Start ``multiproc_smoke`` on ``procs`` gloo ranks on the CPU;
    returns a function that waits for it: ``(exit code, output)``."""
    port = _free_port()
    cmd = [sys.executable, "-m", "pnp_tpu_torch.tools.multiproc_smoke",
           "--procs", str(procs), "--backend", "gloo", "--device", "cpu",
           "--port", str(port), "--timeout", str(LAUNCH_TIMEOUT), *args]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        out, _ = proc.communicate(timeout=LAUNCH_TIMEOUT + 60)
        return proc.returncode, out

    return wait


def worst(a, b) -> float:
    """Largest field and current difference of two runs; ``b`` a result or
    a ``multiproc_smoke`` .npz."""
    get = (lambda r, n: r[n]) if isinstance(b, np.lib.npyio.NpzFile) \
        else (lambda r, n: getattr(r, n))
    fields = max(float(np.abs(np.asarray(getattr(a, n))
                              - np.asarray(get(b, n))).max())
                 for n in ("phi", "cp", "cm"))
    if isinstance(b, np.lib.npyio.NpzFile):
        hist = list(zip(b["times"], b["ip"], b["im"]))
    else:
        hist = b.current_history
    assert len(hist) == len(a.current_history)
    cur = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
              for (_, *xs), (_, *ys) in zip(a.current_history, hist)
              for x, y in zip(xs, ys))
    return max(fields, cur)


@pytest.fixture(scope="module")
def case():
    return problems.one_wall_case(40, 4)


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """The rank runs, started together, and the batch-axis run whose
    checkpoint one of them resumes."""
    tsys, tspace = case
    tmp = tmp_path_factory.mktemp("ranks")
    batch = TD.run_distributed_pnp_from_pb(
        tsys, tspace, K, n_steps=N_STEPS, presolve_potential=True,
        output_dir=str(tmp / "batch"), checkpoint_path=str(tmp / "b.npz"),
        checkpoint_freq=3, device="cpu")
    common = ("--shards", str(K), "--steps", str(N_STEPS), "--presolve")
    waits = {
        "main": ranks(*common, "--output-dir", str(tmp / "ranks"),
                      "--checkpoint", str(tmp / "r.npz"),
                      "--checkpoint-freq", "3", "--two-level-dofs", "0",
                      "--out", str(tmp / "main.npz")),
        "resume": ranks(*common, "--checkpoint", str(tmp / "b.npz"),
                        "--resume", "--out", str(tmp / "resume.npz")),
        "probe": ranks(*common, "--fail-probe-on-rank", "1"),
        "exchange": ranks("--task", "exchange", "--shards", str(K),
                          "--out", str(tmp / "exchange.npz")),
    }
    return dict(tmp=tmp, batch=batch, waits=waits, done={})


def finished(runs, name):
    """The named launch's (exit code, output), once."""
    if name not in runs["done"]:
        runs["done"][name] = runs["waits"][name]()
    return runs["done"][name]


def ok(runs, name):
    rc, out = finished(runs, name)
    assert rc == 0, out[-4000:]
    return np.load(runs["tmp"] / f"{name}.npz")


def test_initialize_distributed(monkeypatch):
    """The reference's rules on torch.distributed: arguments before
    torchrun's variables, False without an address or for one process, an
    explicit backend or NCCL only where each rank has a card; the layout
    with and without a group."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    started = []
    monkeypatch.setattr(PD, "start_process_group",
                        lambda *a, **kw: started.append(a))
    assert PD.initialize_distributed() is False
    assert PD.initialize_distributed("127.0.0.1:1", 1, 0, "gloo") is False
    assert PD.initialize_distributed("127.0.0.1:1", 2, 1, "gloo") is True
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "5")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert PD.initialize_distributed(backend="gloo") is False
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    assert PD.initialize_distributed(backend="gloo") is True
    assert PD.initialize_distributed("h:7", 2, 0, "nccl") is True
    assert started == [("127.0.0.1:1", 2, 1, "gloo"), ("10.0.0.1:5", 3, 2,
                       "gloo"), ("h:7", 2, 0, "nccl")]
    with pytest.raises(ValueError, match="gloo"):     # no card a rank here
        PD.initialize_distributed("h:7", 2, 0)
    with pytest.raises(ValueError, match="gloo"):
        PD.resolve_backend("mpi", 2)
    assert len(started) == 3

    lay = PD.global_device_mesh(8, device="cpu")      # no process group
    assert (lay.world_size, lay.rank, lay.K_local, lay.backend,
            lay.ranked) == (1, 0, 8, None, False)
    assert PD.is_coordinator()
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.global_device_mesh(8)                      # no card here
    for name, value in (("is_initialized", True), ("get_world_size", 2),
                        ("get_rank", 1), ("get_backend", "gloo")):
        monkeypatch.setattr(PD.dist, name, lambda v=value: v)
    lay = PD.global_device_mesh(8, device="cpu")
    assert (lay.world_size, lay.rank, lay.K_local, lay.shards, lay.backend,
            lay.ranked) == (2, 1, 4, slice(4, 8), "gloo", True)
    assert not PD.is_coordinator()
    with pytest.raises(ValueError, match="do not divide"):
        PD.global_device_mesh(3, device="cpu")


def test_rank_rows_and_the_one_level_rule(case):
    """A rank's context keeps its rows of the global plan; the coarse level
    is refused across ranks (built here without a group: nothing of this
    needs a collective)."""
    _, tspace = case
    whole = build_dist_context(tspace, K, "cpu")
    for rank in (0, 1):
        lay = PD.RankLayout(K, 2, rank, torch.device("cpu"), "gloo")
        ctx = build_dist_context(tspace, lay)
        rows = slice(2 * rank, 2 * rank + 2)
        assert (ctx.K, ctx.K_local, ctx.Kb, ctx.E_flat) == (
            K, 2, 2 * ctx.plan.B_N, 2 * ctx.plan.B_E)
        for f in ("dofmap_local", "send_idx", "recv_pos"):
            assert torch.equal(getattr(ctx, f), getattr(whole, f)[rows])
        x = np.arange(tspace.ndof, dtype=np.float64)
        np.testing.assert_array_equal(
            ctx.partition(x), whole.partition(x).reshape(K, -1)[rows].ravel())
        np.testing.assert_array_equal(
            ctx.pad_mask_flat(), whole.pad_mask_flat().reshape(K, -1)[rows]
            .ravel())
        with pytest.raises(NotImplementedError, match="one-level"):
            SW.build_p1_coarse_dist(ctx, None, None, tspace.dof_coords)


def test_exchange_matches_the_batch_axis(runs):
    """Every rank's exchange results, joined in shard order, against the
    same seeded inputs through the batch-axis context."""
    got = ok(runs, "exchange")
    _, ctx, inputs = MS.exchange_case(PD.single_process_layout(K, "cpu"))
    want = MS.exchange_results(ctx, inputs)
    for name in ("forward", "backward", "gather", "scatter", "env", "local"):
        np.testing.assert_array_equal(got[name], want[name].numpy(),
                                      err_msg=name)
    for name in ("spmv", "dot"):
        np.testing.assert_allclose(got[name], want[name].numpy(), rtol=1e-14,
                                   atol=0, err_msg=name)


def test_driver_matches_batch_axis_and_reference(case, runs):
    """2 ranks x 2 shards against the batch-axis driver at K = 4 and the
    reference's driver on a 4-device mesh: the same PB Newton, fields and
    currents to 1e-8; current.dat written once, equal to the batch-axis
    run's; one-level Schwarz over ranks with ``TWO_LEVEL_DOFS`` 0."""
    tsys, tspace = case
    assert len(jax.devices()) >= K
    ref = JD.run_distributed_pnp_from_pb(       # while the ranks run
        jax_sysparams(tsys), JFS(rect_mesh(40, 4, 5.0, 0.5), 1),
        make_device_mesh(K), n_steps=N_STEPS, presolve_potential=True)
    got = ok(runs, "main")
    batch = runs["batch"]
    assert (int(got["n_ranks"]), int(got["n_shards"])) == (2, K)
    assert str(got["poisson_tier"]) == "schwarz"
    assert int(got["pb_newton_iterations"]) == batch.pb_newton_iterations
    assert worst(batch, got) <= ATOL, worst(batch, got)
    np.testing.assert_allclose(got["pb"], batch.system.to_global(
        batch.system.pb), rtol=0, atol=ATOL)
    assert int(got["pb_newton_iterations"]) == int(ref.pb_newton_iterations)
    assert worst(ref, got) <= ATOL, worst(ref, got)
    tmp = runs["tmp"]
    c_r = np.loadtxt(tmp / "ranks" / "current.dat")
    c_b = np.loadtxt(tmp / "batch" / "current.dat")
    assert c_r.shape == c_b.shape == (N_STEPS, 1 + 2 * tsys.n_surfaces)
    np.testing.assert_allclose(c_r, c_b, rtol=0, atol=ATOL)
    assert sorted(os.listdir(tmp / "ranks")) == sorted(
        os.listdir(tmp / "batch"))


def test_tier_rule(case, monkeypatch):
    """With ``TWO_LEVEL_DOFS`` below the case, one process takes two-level
    Schwarz; the ranks above took one level all the same."""
    tsys, tspace = case
    monkeypatch.setattr(TD, "TWO_LEVEL_DOFS", 0)
    pb = np.zeros(tspace.ndof)
    system = TD.build_dist_pnp_system(tsys, tspace, K, pb_field=pb,
                                      device="cpu")
    assert system.poisson_tier == "two_level"


def test_checkpoints_across_ranks_and_one_process(case, runs):
    """A checkpoint written by 2 ranks (after step 3) resumes in one
    process, one written in one process resumes under 2 ranks; both land
    on the uninterrupted run's state."""
    tsys, tspace = case
    full = runs["batch"]
    ok(runs, "main")
    resumed = TD.run_distributed_pnp_from_pb(
        tsys, tspace, K, n_steps=N_STEPS, presolve_potential=True,
        checkpoint_path=str(runs["tmp"] / "r.npz"), resume=True,
        device="cpu")
    assert len(resumed.step_ms) == 1
    got = ok(runs, "resume")
    assert got["step_ms"].shape == (1,)
    assert float(got["time"]) == pytest.approx(full.time)
    for n in ("phi", "cp", "cm"):
        np.testing.assert_allclose(getattr(resumed, n), getattr(full, n),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got[n], getattr(full, n), rtol=0,
                                   atol=ATOL)


def test_probe_failure_on_one_rank_raises_on_all(runs):
    """Every probe verdict of rank 1 fails, rank 0's pass: the count of
    failed matrices is summed over ranks, so both raise
    FloatingPointError at the same call and the launcher exits non-zero
    long before the process group's timeout (by its own clock, from the
    launch to the last rank's exit)."""
    rc, out = finished(runs, "probe")
    assert rc != 0, out[-4000:]
    for rank in (0, 1):
        assert any(line.startswith(f"[rank {rank}]")
                   and "FloatingPointError: batched_inv_f32" in line
                   for line in out.splitlines()), out[-4000:]
    last = out.strip().splitlines()[-1]
    assert last.startswith("multiproc_smoke: 2 ranks, exit "), last
    seconds = float(last.split(" after ")[1].split()[0])
    assert seconds < PD.TIMEOUT_S, last
