"""The frozen FLOP count against a hand count, and against the program's
own analytic model at Yi-9B's shape."""

import dataclasses
import json

import pytest

from counts import lm
from harness import core


def test_lm_forward_flops_by_hand():
    # d=8, 2 heads of 4, 1 KV head, d_ff 16, vocab 10, one layer, batch 1 x 4 tokens
    proj = 2 * 8 * (2 * 2 * 4 + 2 * 1 * 4)
    attn = 4 * 2.0 * 2 * 4
    mlp = 2 * 8 * 16 * 3
    want = 4 * (proj + attn + mlp) + 4 * 2 * 8 * 10
    got = lm.forward_flops(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16, vocab=10,
                           num_layers=1, batch=1, seq=4)
    assert got == want
    assert lm.train_step_flops(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16, vocab=10,
                               num_layers=1, batch=1, seq=4) == 3 * want


@pytest.mark.parametrize("traffic", ["sgd_short", "sgd_long"])
def test_lm_count_is_the_analytic_model_without_recompute(traffic):
    from repro_torch.configs import get_config
    from repro_torch.launch.analytic import step_counts

    cfg = json.loads((core.BENCH / "configs" / "yi9b_l1.json").read_text())
    tr = json.loads((core.BENCH / "traffic" / f"{traffic}.json").read_text())
    arch = dataclasses.replace(get_config("yi_9b"), num_layers=1)
    # the analytic model counts remat's recompute: four forwards where this counts three
    want = step_counts(arch, (tr["seq"], tr["batch"], "train"), 0)["flops"] * 3.0 / 4.0
    a = cfg["arch"]
    got = lm.train_step_flops(d_model=a["d_model"], num_heads=a["num_heads"], num_kv_heads=a["num_kv_heads"],
                              head_dim=a["d_model"] // a["num_heads"], d_ff=a["d_ff"], vocab=a["vocab"],
                              num_layers=1, batch=tr["batch"], seq=tr["seq"])
    assert got == pytest.approx(want, rel=1e-12)


def test_yi_config_matches_the_program_config_but_depth():
    from repro_torch.configs import get_config

    cfg = json.loads((core.BENCH / "configs" / "yi9b_l1.json").read_text())
    prog = dataclasses.asdict(get_config("yi_9b"))
    diff = {k for k, v in cfg["arch"].items() if prog[k] != v}
    assert diff == {"num_layers"} and prog["num_layers"] == cfg["published_num_layers"]
