"""Each cell's path through the harness on the CPU at a tiny size: the
set-up, the window, the traced window's readers, the output check; and
the check coming out false with the timed path broken underneath."""

import json
import time

import pytest
from conftest import TINY  # noqa: I001

import faults
import run
from harness import core

MAN = core.load_manifest()
CELLS = [(w["name"], json.loads((core.ROOT / next(c["file"] for c in MAN["configs"]
                                                  if c["name"] == w["config"])).read_text())["system"])
         for w in MAN["workloads"]]


def _run(cell, system, trace=False, seed=2 ** 31 + 77):
    line, checks = run.run_cell(cell, seed, 2.0 if trace else 0.5, trace, device="cpu",
                                t_start=time.perf_counter(), overrides=TINY[system])
    return json.loads(line), checks


@pytest.mark.parametrize("cell,system", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(cell, system):
    out, checks = _run(cell, system)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in core.end_to_end_for(MAN, cell)}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks" and len(checks) == len(out["checks"])


@pytest.mark.parametrize("cell,system", CELLS)
def test_traced_cell_reports_its_per_layer_metrics(cell, system):
    out, _ = _run(cell, system, trace=True)
    assert out["correct"]
    want = {m["name"] for m in core.per_layer_for(MAN, cell)}
    # on the CPU the trace has no device: the device readers find nothing
    device_only = {n for n in want if n.endswith("device_idle")}
    assert want - device_only <= set(out["metrics"]) <= want
    assert "busy_s" in out["device"] and "breakdown" in out


def test_same_seed_same_inputs():
    import torch

    from harness import lm_inputs

    arch = TINY["tmsn_sgd"]["config"]["arch"]
    a, b, c = (lm_inputs.make_weights(arch, s, torch.device("cpu")) for s in (2 ** 31 + 5, 2 ** 31 + 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["embed"], c["embed"])
    t = [lm_inputs.tokens(s, 1, 0, (2, 2, 16), 256, torch.device("cpu")) for s in (2 ** 31 + 5, 2 ** 31 + 5, 6)]
    assert torch.equal(t[0], t[1]) and not torch.equal(t[0], t[2])


def test_delivery_takes_the_best_other_certificate_that_beats_its_own():
    from systems.tmsn_sgd import delivery

    assert delivery([3.0, 2.0, 2.5], [True, True, True], 0.0) == [1, 1, 1]
    assert delivery([3.0, 2.0, 2.5], [True, False, True], 0.0) == [2, 1, 2]
    assert delivery([3.0, 2.9], [True, True], 0.2) == [0, 1]


@pytest.mark.parametrize("cell,system", CELLS)
def test_the_control_comes_out_not_correct_through_the_runs_own_check(cell, system):
    line, checks = run.run_cell(cell, 2 ** 31 + 77, 0.5, False, device="cpu", t_start=time.perf_counter(),
                                overrides=TINY[system], control=True)
    out = json.loads(line)
    assert not out["correct"], out["checks"]
    program = out["notes"]["program_checks"]
    assert all(program[name] <= limit for name, _, limit in checks), (program, out["checks"])


@pytest.mark.parametrize("cell,system", CELLS)
def test_a_fault_in_one_worker_alone_is_found(cell, system):
    """The second worker's optimizer steps leave its parameters as they
    were (its losses still come), whichever worker has the best
    certificate."""
    from repro_torch.core import sgd_worker

    step, calls = sgd_worker.apply_updates_, []

    def apply_updates_(params, grads, state, cfg, lr=None, out=None):
        calls.append(1)
        step(params, grads, state, cfg, lr=lr, out=out)
        k = TINY[system]["traffic"].get("local_steps") or core.cell_files(MAN, cell)[3]["local_steps"]
        if (len(calls) - 1) // k % 2 == 1:
            faults._copy_tree(out[0] if out is not None else params, params)

    with faults._patched(sgd_worker, "apply_updates_", apply_updates_):
        out, _ = _run(cell, system)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,system", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "exchange_left_out", "answer_altered"])
def test_check_fails_with_the_timed_path_broken(cell, system, fault):
    with faults.FAULTS[system][fault]():
        out, _ = _run(cell, system)
    assert not out["correct"], out["checks"]
