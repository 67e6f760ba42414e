"""``spans.py`` on synthetic traces and, on the CPU, on a throwaway cell:
the device's busy and idle time inside program spans, the kernels
launched inside them, idle gaps named by the innermost span, and the
recorded segment's counts."""

import time

import pytest

from benchmark import spans
from benchmark.tests.cells import TINY, write_tiny_cell


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


#: device busy over [0, 10] and [20, 30]; span "a" holds the host over
#: [5, 25] with an "a" and a "b" nested in it; the kernel launched inside
#: the nested "a" runs for 10 us; sorted by start, as the tool passes them
EVENTS = sorted([
    _x("kernel", "k0", 0, 10, correlation=1),
    _x("kernel", "k1", 20, 10, correlation=2),
    _x("user_annotation", "a", 5, 20),
    _x("user_annotation", "a", 8, 4),
    _x("user_annotation", "b", 9, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 9, 1, correlation=2),
    _x("cpu_op", "aten::item", 9.5, 2),
    _x("user_annotation", "species", 0, 40),
], key=lambda e: e["ts"])
BUSY = spans._busy(EVENTS)


def test_attribute_reads_a_known_busy_idle_split():
    got = spans.attribute(EVENTS, BUSY, {"a", "b"})
    a = got["a"]
    # the nested "a" lies inside the outer one: counted once in its name
    assert a["count"] == 2
    assert a["host_s"] == pytest.approx(20e-6)
    assert a["busy_s"] == pytest.approx(10e-6)     # [5, 10] and [20, 25]
    assert a["idle_s"] == pytest.approx(10e-6)     # [10, 20]
    assert a["launched_s"] == pytest.approx(10e-6)  # k1 once, not twice
    b = got["b"]
    assert (b["busy_s"], b["idle_s"]) == pytest.approx((1e-6, 2e-6))
    assert b["launched_s"] == pytest.approx(10e-6)
    assert "species" not in got


def test_idle_gaps_take_the_innermost_program_span():
    assert spans.name_gaps(EVENTS, BUSY, {"a", "b"}, ("species",)) == [
        ["b:aten::item", pytest.approx(10e-6)]]
    # without program spans the layer range names the gap
    assert spans.name_gaps(EVENTS, BUSY, set(), ("species",)) == [
        ["species:aten::item", pytest.approx(10e-6)]]
    assert spans.name_gaps(EVENTS, BUSY, {"a"}, by_op=False) == [
        ["a", pytest.approx(10e-6)]]


def test_numbers_without_a_trace_leave_the_device_out():
    from pnp_tpu_torch.utils import profiling as P
    import torch

    with P.recording() as rec:
        P.host_read(torch.tensor(3.0))
        P.host_copy(torch.zeros(2))
    got = spans.program_numbers(rec, 2)
    assert got["host_syncs_per_step"] == 1.0
    assert got["sync_wait_ms"] > 0.0
    assert got["poisson_idle_ms"] is got["species_idle_ms"] is None
    assert got["gj_inverse_ms"] is None
    attributed = {"pnp.poisson_solve": {"idle_s": 4e-3},
                  "pnp.species_step": {"idle_s": 1e-3},
                  "pnp.species_factor": {"idle_s": 1e-3},
                  "kernels.gj_inverse": {"launched_s": 2e-3}}
    got = spans.program_numbers(rec, 2, attributed)
    assert got["poisson_idle_ms"] == pytest.approx(2.0)
    assert got["species_idle_ms"] == pytest.approx(1.0)
    assert got["gj_inverse_ms"] == pytest.approx(1.0)


def test_throwaway_cell_reads_the_host_syncs_and_their_wait(tmp_path):
    """A run of the tiny cell on the CPU: the result is ``run.py``'s,
    correct, and the recorded segment counts the dense tier's reads (the
    probe's and the refinement checks) and their host time."""
    root = write_tiny_cell(tmp_path)
    r = spans.run(root, TINY, 2 ** 31 + 777, 2.0, "cpu", time.perf_counter())
    assert r["correct"] is True
    prog = r["program"]
    assert prog["steps"] == 4 and prog["wall_s"] > 0
    assert len(prog["on_cost"]["off_s"]) == len(prog["on_cost"]["on_s"]) == 2
    numbers = prog["numbers"]
    assert numbers["host_syncs_per_step"] >= 3
    assert numbers["sync_wait_ms"] > 0
    assert numbers["poisson_idle_ms"] is None
    assert prog["spans"]["pnp.species_step"]["count"] == 4
    assert prog["spans"]["pnp.poisson_solve"]["count"] == 4
    assert prog["spans"]["host.sync"]["count"] == (
        4 * numbers["host_syncs_per_step"])


def test_the_command_refuses_a_machine_without_the_card(capsys):
    """As ``run.py``: no CUDA device, no result (exit 3); an unknown cell,
    exit 2."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--seed", str(2 ** 31 + 5), "--seconds", "1"]
    assert spans.main(["--workload", "pore_pnp.transient"] + args) == 3
    assert spans.main(["--workload", "no_such.cell"] + args) == 2
    assert capsys.readouterr().out == ""
