"""The check that nothing of JAX or the JAX package is loaded."""

import ast
import subprocess
import sys

from harness import core


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    mods = ["repro_torch", "repro_torch.core", "jax", "jaxlib.xla_client", "flax.linen", "repro",
            "repro.core", "benchmarks.run", "reproducible", "jaxtyping", "torch"]
    assert core.forbidden_loaded(dict.fromkeys(mods)) == sorted(
        ["jax", "jaxlib.xla_client", "flax.linen", "repro", "repro.core", "benchmarks.run"])


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in core.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in core.FORBIDDEN_MODULES, (path, n)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.argv = ['x']; sys.path.insert(0, 'bench'); import run; "
            "from harness import core; "
            "import repro_torch.core.engine, repro_torch.core.sgd_worker; "
            "import repro_torch.models; print(core.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_exits_nonzero_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command measures")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "yi9b_l1.sgd_short", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
