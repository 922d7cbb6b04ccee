"""The control on the card, at each cell's committed sizes: the reference,
put in the program's place and computed one precision below the
configuration's (float8 for the LM's bfloat16 compute), comes out not
correct through the run's own check, while the program's readings of
the same run lie within the limits."""

import gc
import json
import time

import pytest

import run
from harness import core

MAN = core.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        line, checks = run.run_cell(cell, 2 ** 31 + 91, 1.0, False, device="cuda", t_start=time.perf_counter(),
                                    control=True)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    out = json.loads(line)
    assert not out["correct"], out["checks"]
    program = out["notes"]["program_checks"]
    assert all(program[name] <= limit for name, _, limit in checks), (program, out["checks"])
