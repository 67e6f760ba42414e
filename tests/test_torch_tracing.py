"""The port's span recorder and host-sync counter
(``pnp_tpu_torch.utils.profiling``) on the CPU: spans nest and keep their
attributes, nothing is recorded outside ``recording()``, a Krylov solve
counts its reads, an AMG solve records its build and its applies, and
over a species step and a Poisson solve of the
production system, on each of its Poisson tiers, the counter equals both
the host reads the profiler sees and the tensor reads Python makes; on
the card (``-m cuda``, with ``--noconftest``: this module imports no
jax), it equals the operations that wait for the device."""

import contextlib
import dataclasses
import warnings

import pytest
import torch
from torch.overrides import TorchFunctionMode

from pnp_tpu_torch import problems
from pnp_tpu_torch.fem import assembly as FA
from pnp_tpu_torch.fem.geometry import build_volume_tables
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.meshio.structured import rect_mesh
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.operators import volume as V
from pnp_tpu_torch.solvers import amg, krylov
from pnp_tpu_torch.solvers import linear_problem as LP
from pnp_tpu_torch.utils import profiling as P
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W

#: every span name the port opens
PROGRAM_SPANS = {
    "pnp.species_factor", "pnp.species_step", "pnp.poisson_solve",
    "krylov.bicgstab", "krylov.cg", "ras.local", "ras.coarse",
    "amg.setup", "amg.build", "amg.smooth", "amg.coarse", "direct.refine",
    "direct.inverse_apply", "direct.inverse_large_setup", "host.sync",
    "host.copy", "kernels.gj_inverse",
    "kernels.pb_residual_jacobian", "kernels.element_spmv",
    "kernels.cg_update", "kernels.cg_direction", "kernels.krylov_unconverged",
    "ionflux",
    "pnp.step", "pnp.output",
    "pnp.checkpoint", "pnp.setup.phase_a", "pnp.setup.phase_b",
    "pnp.setup.phase_c"}

#: stretches of the production system at 488 dofs, each on one Poisson
#: tier: the tier, the solver variant (None: the case's own), the build's
#: options, the spans the stretch opens beside the species step and the
#: solve, and the spans its build opens that the stretch does not. The
#: very-large tier is forced at this size by setting
#: ``POISSON_INV_MAX_DOFS`` to 0 while it builds (:func:`_build`)
CASES = {
    "dense": ("dense", None, {}, {"direct.refine", "direct.inverse_apply",
                                  "kernels.gj_inverse"}, set()),
    "ras": ("ras", None, dict(dense_poisson_threshold=0, ras_block_size=64,
                              poisson_inv_threshold=0),
            {"krylov.bicgstab", "ras.local", "ras.coarse",
             "kernels.gj_inverse"}, set()),
    "inverse": ("inverse", None, dict(dense_poisson_threshold=0,
                                      ras_block_size=64),
                {"direct.refine", "direct.inverse_apply", "krylov.bicgstab",
                 "ras.local", "kernels.gj_inverse"}, set()),
    "inverse_large": ("inverse_large", None,
                      dict(dense_poisson_threshold=0, ras_block_size=64),
                      {"direct.inverse_apply", "direct.refine",
                       "kernels.gj_inverse"},
                      {"direct.inverse_large_setup"}),
    "krylov": ("krylov", "BCGS_Jacobi", dict(dense_poisson_threshold=0),
               {"krylov.bicgstab"}, set()),
    "amg": ("krylov", "CG_AMG_SSOR", dict(dense_poisson_threshold=0),
            {"krylov.cg", "amg.build", "amg.smooth", "amg.coarse"}, set()),
}

#: what ``torch.cuda.set_sync_debug_mode("warn")`` says at each operation
#: that waits for the device (its first call adds a warning of its own)
SYNC_WARNING = "called a synchronizing CUDA operation"

#: Tensor methods that bring a tensor's data to the host, or whose result
#: size depends on it (a device sync on the card)
_READS = {"item", "__bool__", "__float__", "__int__", "__index__", "tolist",
          "numpy", "nonzero", "argwhere", "masked_select", "unique",
          "unique_consecutive"}


def test_spans_nest_with_parent_ids_and_keep_attrs():
    with P.recording() as rec:
        with P.span("outer", a=1) as outer:
            with P.span("inner"):
                pass
            with P.span("inner") as second:
                second.set(k=7)
            outer.set(b=2)
        with P.span("after"):
            pass
    names = [(s.name, s.id, s.parent) for s in rec.spans]
    assert names == [("outer", 0, None), ("inner", 1, 0), ("inner", 2, 0),
                     ("after", 3, None)]
    assert rec.spans[0].attrs == {"a": 1, "b": 2}
    assert rec.spans[2].attrs == {"k": 7} and rec.spans[1].attrs == {}
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    assert rec.spans[0].start_ns <= rec.spans[1].start_ns
    assert rec.spans[2].end_ns <= rec.spans[0].end_ns
    summary = rec.summary()
    assert {k: v["count"] for k, v in summary.items()} == {
        "outer": 1, "inner": 2, "after": 1}
    assert summary["outer"]["host_s"] >= summary["inner"]["host_s"] >= 0.0


@pytest.mark.parametrize("case", ["dense", "inverse_large"])
def test_recording_off_records_nothing(case):
    """Off: one shared no-op context for every name, host reads return the
    value and count nothing, and a profiled build (the very-large tier's
    set-up among them), presolve, species step and Poisson solve carry no
    program range."""
    assert P.span("pnp.step", step=3) is P.span("ras.local")
    P.counters.host_syncs = 0
    with P.span("pnp.step") as sp:
        sp.set(iterations=2)
        assert P.host_read(torch.tensor(True)) is True
        assert P.host_copy(torch.ones(2)).tolist() == [1.0, 1.0]
    assert P.counters.host_syncs == 0
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        system = _build(case, "cpu")
        u = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)[0]
        cp, cm, _ = system.species_step(u, system.ucp0, system.ucm0)
        system.poisson_solve(u, cp, cm)
    names = {e.name for e in prof.events()}
    assert not names & PROGRAM_SPANS
    assert P.counters.host_syncs == 0


def test_recording_resets_counters():
    P.counters.host_syncs = 5
    with P.recording() as rec:
        assert P.counters.host_syncs == 0
        P.host_read(torch.tensor(1.0))
    assert rec.counters.host_syncs == 1
    with P.recording() as rec:
        pass
    assert rec.counters.host_syncs == 0 and rec.spans == []


@pytest.mark.parametrize("solver", ["bicgstab", "cg"])
def test_a_krylov_solve_counts_k_plus_two_syncs(solver):
    """One read a loop test (k + 1) and one in the result: k + 2, and one
    span with the solve's iterations and verdict."""
    n = 40
    main = torch.full((n,), 4.0, dtype=torch.float64)
    A = (torch.diag(main) - torch.diag(torch.ones(n - 1), 1)
         - torch.diag(torch.ones(n - 1), -1)).to(torch.float64)
    b = torch.linspace(-1.0, 1.0, n, dtype=torch.float64)
    with P.recording() as rec:
        res = getattr(krylov, solver)(lambda x: A @ x, b, torch.zeros_like(b),
                                      reduction=1e-10)
    k = res.iterations
    assert res.converged and 0 < k < n
    assert rec.counters.host_syncs == k + 2
    solves = [s for s in rec.spans if s.name == f"krylov.{solver}"]
    assert len(solves) == 1
    assert solves[0].attrs == {"iterations": k, "converged": True}
    syncs = [s for s in rec.spans if s.name == "host.sync"]
    assert len(syncs) == k + 2
    assert all(s.parent == solves[0].id for s in syncs)


def test_an_amg_solve_records_one_build_and_a_coarse_span_an_apply():
    """One CG solve under the two-level AMG of k iterations: one
    ``amg.build`` (with its s, n_agg and e) and one count of
    ``amg_builds``, k + 1 preconditioner applies (one before the loop),
    each with one ``amg.coarse`` and two ``amg.smooth`` inside the
    ``krylov.cg`` span, which opens after the build; the aggregation is
    one ``amg.setup``. With
    recording off the same solve records and counts nothing."""
    space = FunctionSpace(rect_mesh(24, 24, 1.0, 1.0), 1)
    vt = build_volume_tables(space, 2, "cpu")
    A_el = V.laplace_jacobian_el(vt)
    n = space.ndof
    free = torch.ones(n, dtype=torch.bool)
    free[torch.as_tensor(space.bedge_dofs).unique()] = False
    op = FA.make_constrained_operator(A_el, vt.dofmap, n, free)
    diag = FA.constrained_diagonal(A_el, vt.dofmap, n, free)
    b = torch.sin(torch.arange(n, dtype=torch.float64)) * free
    with P.recording() as rec:
        ctx = amg.make_amg_context(vt.dofmap, n, free, 64,
                                   dof_coords=space.dof_coords)
    assert [(s.name, s.attrs) for s in rec.spans] == [
        ("amg.setup", {"ndof": n, "n_agg": 64,
                       "largest": ctx.members.shape[1]})]
    solve = LP.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=ctx)
    with P.recording() as rec:
        res = solve(op, b, torch.zeros_like(b), diag, 1e-8, A_el=A_el)
    k = res.iterations
    assert res.converged and k > 1
    assert rec.counters.amg_builds == 1
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["amg.build"]) == 1
    assert by["amg.build"][0].attrs == {"s": 1, "n_agg": 64,
                                        "e": A_el.shape[0]}
    assert len(by["amg.coarse"]) == k + 1
    assert len(by["amg.smooth"]) == 2 * (k + 1)
    cg_id = by["krylov.cg"][0].id
    assert by["amg.build"][0].parent is None      # built before the loop
    assert all(s.parent == cg_id for s in by["amg.coarse"] + by["amg.smooth"])
    P.counters.amg_builds = 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        off = solve(op, b, torch.zeros_like(b), diag, 1e-8, A_el=A_el)
    assert off.iterations == k and torch.equal(off.x, res.x)
    assert not {e.name for e in prof.events()} & PROGRAM_SPANS
    assert P.counters.amg_builds == 0


def _scalar_reads(prof) -> int:
    """Host reads of a tensor's value in a profiled stretch: on the CPU
    ``bool(t)``, ``float(t)`` and ``t.item()`` each run one of these, and
    so does a library call that reads an error flag back (such as
    ``torch.linalg.cholesky`` or ``inv``: a device sync on the card)."""
    return sum(e.name == "aten::_local_scalar_dense" for e in prof.events())


class _TensorReads(TorchFunctionMode):
    """Counts the calls of :data:`_READS`, and indexing by a boolean mask,
    made from Python, outside kernel 1's plain version: that stands in on
    the CPU for the CUDA kernel, which reads nothing back."""

    def __init__(self):
        super().__init__()
        self.count = 0
        self._plain = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if not self._plain and (name in _READS or (
                name in ("__getitem__", "__setitem__")
                and _has_mask(args[1]))):
            self.count += 1
        return func(*args, **(kwargs or {}))

    def plain(self, core):
        """``core`` with this mode's count paused inside it."""
        def paused(*args, **kwargs):
            self._plain += 1
            try:
                return core(*args, **kwargs)
            finally:
                self._plain -= 1
        return paused


def _has_mask(index) -> bool:
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(p, torch.Tensor) and p.dtype == torch.bool
               and p.ndim > 0 for p in parts)


def _build(case, device):
    """The case's system on ``device``; the very-large tier forced by
    ``POISSON_INV_MAX_DOFS`` 0 while it builds."""
    tier, solver, options = CASES[case][:3]
    sysp, space = problems.pore_case(30, 17)
    if solver:
        sysp = dataclasses.replace(sysp, linearSolver=solver)
    with pytest.MonkeyPatch.context() as mp:
        if tier == "inverse_large":
            mp.setattr(W, "POISSON_INV_MAX_DOFS", 0)
        system = W.build_pnp_system(sysp, space, device=device, **options)
    assert system.poisson_tier == tier
    return system


def _system(case, device):
    """The case's system on ``device``, the span names its build records,
    and its presolved potential."""
    with P.recording() as rec:
        system = _build(case, device)
    return system, {s.name for s in rec.spans}, system.poisson_solve(
        system.uphi0, system.ucp0, system.ucm0)[0]


def _stretch(system, u):
    """One species step with a fresh factor, then a Poisson solve."""
    cp, cm, k = system.species_step(u, system.ucp0, system.ucm0)
    system.poisson_solve(u, cp, cm)
    return k


def _check_spans(case, system, rec, k, built):
    """The stretch's spans, with ``built`` the names its build recorded."""
    names = {s.name for s in rec.spans}
    assert CASES[case][3] | {"pnp.species_step", "pnp.poisson_solve",
                                  "host.sync"} <= names
    assert CASES[case][4] <= built - names
    assert names | built <= PROGRAM_SPANS
    step = [s for s in rec.spans if s.name == "pnp.species_step"]
    assert step[0].attrs == {"iterations": k}
    solve = [s for s in rec.spans if s.name == "pnp.poisson_solve"]
    assert solve[0].attrs["tier"] == system.poisson_tier
    return names


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_counter_misses_no_sync(case, monkeypatch):
    """A species step (a fresh factor) and a Poisson solve under the
    profiler, on the CPU: recorded, the counter equals the profiler's
    scalar reads (``.item()``, ``bool``, ``float`` and the library's own
    error-flag reads) and the tensor reads made from Python (also
    ``.tolist()``, ``.numpy()``, ``nonzero``, masked indexing);
    unrecorded, the stretch reads as often (recording adds none). A read
    that only a CUDA branch makes shows only on the card (below)."""
    system, built, u = _system(case, "cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]
    reads, python_reads = {}, {}
    core = K._gj_core_plain
    for on in (True, False):
        mode = _TensorReads()
        monkeypatch.setattr(K, "_gj_core_plain", mode.plain(core))
        with (P.recording() if on else contextlib.nullcontext()) as rec:
            with torch.profiler.profile(activities=acts) as prof, mode:
                k = _stretch(system, u)
        reads[on], python_reads[on] = _scalar_reads(prof), mode.count
        if on:
            assert rec.counters.host_syncs == reads[on] > 0
            assert rec.counters.host_syncs == python_reads[on]
            names = _check_spans(case, system, rec, k, built)
            events = {e.name for e in prof.events()}
            assert names <= events       # the spans are profiler ranges
    assert reads[True] == reads[False]
    assert python_reads[True] == python_reads[False]


@pytest.mark.parametrize("case", sorted(CASES))
def test_inverse_apply_spans_count_the_refinements_and_the_probe(case):
    """Over a build, its presolve and a stretch, recorded: one
    ``direct.inverse_apply`` span an apply, as many as the
    ``direct.refine`` spans' refinements and the very-large probe's four
    applies (two refinements of each of its two vectors), each apply
    inside a refinement or the probe."""
    with P.recording() as rec:
        system = _build(case, "cpu")
        u = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)[0]
        _stretch(system, u)
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    refinements = sum(s.attrs["refinements"]
                      for s in by.get("direct.refine", []))
    setups = by.get("direct.inverse_large_setup", [])
    applies = by.get("direct.inverse_apply", [])
    assert len(applies) == refinements + 4 * len(setups)
    assert (len(applies) > 0) == (case in ("dense", "inverse",
                                           "inverse_large"))
    owners = {s.id for s in by.get("direct.refine", []) + setups}
    assert all(s.parent in owners for s in applies)
    if case == "inverse_large":
        (setup,) = setups
        assert setup.attrs == {"n": system.space.ndof, "ok": True}
        assert [s.attrs for s in applies if s.parent == setup.id] == [
            {"s": 1, "n": system.space.ndof, "equilibrated": True}] * 4
        gj = [s for s in by["kernels.gj_inverse"] if s.parent == setup.id]
        assert [s.attrs["n"] for s in gj] == [system.space.ndof]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_counter_misses_no_sync_on_the_card(case):
    """The same stretch on the card, after one unrecorded warm-up, under
    ``torch.cuda.set_sync_debug_mode("warn")``, which warns at each
    operation that waits for the device (a prototype of PyTorch's, which
    does not promise to see every one): recorded, the counter equals the
    warnings; unrecorded, the stretch warns as often, less the reads that
    its graphed Krylov loops save (recording keeps them eager): one read a
    device-side loop in place of one an iteration it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    system, built, u = _system(case, "cuda")
    _stretch(system, u)
    torch.cuda.synchronize()
    syncs, saved, loops = {}, {}, {}
    for on in (True, False):
        counts = dict(krylov.graph_counts)
        with (P.recording() if on else contextlib.nullcontext()) as rec, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                k = _stretch(system, u)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[on] = sum(SYNC_WARNING in str(w.message) for w in caught)
        loops[on] = krylov.graph_counts["loops"] - counts["loops"]
        saved[on] = (krylov.graph_counts["replays"] - counts["replays"]
                     - loops[on])
        if on:
            assert rec.counters.host_syncs == syncs[on] > 0
            _check_spans(case, system, rec, k, built)
    assert loops[True] == 0
    assert (loops[False] > 0) == (case in ("ras", "amg"))
    assert syncs[False] == syncs[True] - saved[False]
