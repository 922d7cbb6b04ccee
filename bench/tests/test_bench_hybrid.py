"""The hybrid cells' own pieces: the layout against the program's tree at
the committed widths, the configuration against the published numbers,
the FLOP count by hand, the readers of the SSM spans, and each Mamba-2
fault found by the check on the CPU at a tiny size. Importing this file
adds the hybrid system's tiny shapes to ``conftest.TINY`` and its faults
to ``faults.FAULTS`` (``faults_hybrid.py``), which the rehearsal tests of
every cell read."""

import json
import math
import time

import pytest
from conftest import TINY

import faults_hybrid
import run
from counts import nemotron_h
from harness import core

TINY.setdefault("tmsn_sgd_hybrid", {
    "config": {"arch": {
        "name": "tiny-nemotron-h", "arch_type": "hybrid", "num_layers": 7, "layer_pattern": "MEMEM*E",
        "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "moe_d_ff": 32,
        "vocab": 256, "rope": False, "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
        "mlp_gated": False, "ssm_state": 16, "ssm_head_dim": 16, "ssm_heads": 8, "ssm_expand": 2,
        "ssm_groups": 4, "ssm_conv_width": 4, "ssm_chunk": 8, "num_experts": 16,
        "num_experts_per_tok": 4, "num_shared_experts": 2, "expert_act": "relu2", "router_score": "sigmoid",
        "routed_scaling_factor": 2.5, "router_bias_rate": 0.001, "router_aux_coef": 0.0001,
        "moe_dispatch": "dropless", "experts_held": 4, "experts_offset": 0, "mtp_depth": 0,
        "param_dtype": "float32", "compute_dtype": "float32", "remat": True}},
    "traffic": {"batch": 2, "seq": 16, "traced_rounds": 1}})

MAN = core.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]
         if core.cell_files(MAN, w["name"])[2]["system"] == "tmsn_sgd_hybrid"]


def _cfg(cell):
    return core.cell_files(MAN, cell)[2]


@pytest.mark.parametrize("cell", CELLS)
def test_layout_is_the_programs_tree_at_the_committed_widths(cell):
    from harness import lm_inputs
    from repro_torch.models import init_params
    from repro_torch.models.config import ArchConfig
    from systems import tmsn_sgd_hybrid

    arch = _cfg(cell)["arch"]
    have = [(n, tuple(t.shape)) for n, t in lm_inputs.flatten(
        init_params(ArchConfig(**arch), 0, device="meta")).items()]
    assert have == [(n, tuple(s)) for n, s, _ in tmsn_sgd_hybrid.layout(arch)]
    assert sum(math.prod(s) for _, s in have) == 767_561_664


@pytest.mark.parametrize("cell", CELLS)
def test_config_keeps_the_published_numbers_but_the_cut(cell):
    from systems import tmsn_sgd_hybrid

    cfg, a = _cfg(cell), _cfg(cell)["arch"]
    pairs = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "moe_intermediate_size": "moe_d_ff", "n_routed_experts": "num_experts",
             "num_experts_per_tok": "num_experts_per_tok", "routed_scaling_factor": "routed_scaling_factor",
             "norm_eps": "norm_eps", "mamba_num_heads": "ssm_heads", "mamba_head_dim": "ssm_head_dim",
             "ssm_state_size": "ssm_state", "n_groups": "ssm_groups", "conv_kernel": "ssm_conv_width",
             "chunk_size": "ssm_chunk", "expand": "ssm_expand", "num_hidden_layers": "num_layers",
             "hybrid_override_pattern": "layer_pattern", "vocab_size": "vocab",
             "experts_held": "experts_held"}
    assert all(cfg[k] == a[k2] for k, k2 in pairs.items())
    assert a["expert_act"] == cfg["mlp_hidden_act"] == "relu2"
    assert a["moe_d_ff"] * a["num_shared_experts"] == cfg["moe_shared_expert_intermediate_size"]
    assert {k for k, v in cfg["published"].items() if cfg[k] != v} == set(cfg["published"])
    assert cfg["published"]["hybrid_override_pattern"].startswith(cfg["hybrid_override_pattern"])
    assert (tmsn_sgd_hybrid.DT_RANGE, tmsn_sgd_hybrid.DT_FLOOR) == (
        (cfg["time_step_min"], cfg["time_step_max"]), cfg["time_step_floor"])
    entry = next(c for c in MAN["configs"] if c["name"] == next(w["config"] for w in MAN["workloads"]
                                                                 if w["name"] == cell))
    assert set(entry["reduced"]) == set(cfg["published"])


def test_flops_by_hand():
    # d 8; Mamba-2 2 heads of 4, state 2, 1 group, chunk 4; 2 q heads over 1 kv head of 4;
    # E 4, k 2, 2 held, expert 8, 1 shared; vocab 10; pattern "ME*", 1 x 4 tokens
    ssm = 2 * 8 * (2 * 8 + 2 * 2 + 2) + 2 * 8 * 8 + 2 * 4 * 1 * 2 + 2 * 4 * 2 * 4 + 2 * 2 * 2 * 4 * 2
    moe = 2 * 8 * 4 + (1 + 2 * 2 / 4) * 2 * 8 * 8 * 2
    attn = 2 * 8 * (2 + 2) * 4 + 2 * 2 * 4 * 8 + 4 * 2.0 * 2 * 4
    want = 4 * (ssm + moe + attn + 2 * 8 * 10)
    shape = dict(pattern="ME*", d_model=8, ssm_heads=2, ssm_head_dim=4, ssm_state=2, ssm_groups=1,
                 ssm_chunk=4, num_heads=2, num_kv_heads=1, head_dim=4, moe_d_ff=8, num_experts=4,
                 num_experts_per_tok=2, num_shared_experts=1, experts_held=2, vocab=10, batch=1, seq=4)
    assert nemotron_h.forward_flops(**shape) == want
    assert nemotron_h.train_step_flops(**shape) == 3 * want
    assert nemotron_h.expert_mm_flops(10, 8, 4, 4) == 4 * 10 * 8 * 4 * 4


@pytest.mark.parametrize("name", ["ssm.scan_ms", "ssm.mixer_ms"])
def test_ssm_readers_on_a_made_up_record(name):
    rec = {"program": {"span_ms_per_step": {"ssm.scan": 12.5, "ssm.mixer": 40.0}}}
    assert core.read_metric(name, rec) == {"ssm.scan_ms": 12.5, "ssm.mixer_ms": 40.0}[name]
    assert core.read_metric(name, {"program": {"span_ms_per_step": {"moe.route": 1.0}}}) is None


def test_program_record_reads_the_ssm_spans_and_counts_two_products():
    from types import SimpleNamespace

    from systems import tmsn_sgd_hybrid

    program = {"spans": [{"name": "ssm.scan", "device_ms": 3.0}, {"name": "ssm.mixer", "device_ms": 8.0},
                         {"name": "ssm.scan", "device_ms": 1.0}, {"name": "engine.round", "device_ms": 99.0}],
               "counters": {"moe.rows": {"": [3, 5]}, "ssm_calls": {"full": 4}, "host_syncs": {"x": 1}}}
    arch = TINY["tmsn_sgd_hybrid"]["config"]["arch"]
    rec = tmsn_sgd_hybrid.program_record(program, 2, arch, SimpleNamespace(events=lambda: []))
    assert rec["span_ms_per_step"]["ssm.scan"] == 2.0 and rec["span_ms_per_step"]["ssm.mixer"] == 4.0
    assert set(rec["counters"]) == {"moe.rows", "ssm_calls"}
    assert rec["expert_mm_flops"] == 4.0 * 8 * 64 * 32 * 4


def test_the_hybrid_system_leaves_the_moe_systems_pieces_its_own():
    import importlib

    from systems import tmsn_sgd_hybrid, tmsn_sgd_moe

    importlib.reload(tmsn_sgd_moe)
    assert tmsn_sgd_moe.layout is not tmsn_sgd_hybrid.layout
    assert tmsn_sgd_hybrid._base.layout is tmsn_sgd_hybrid.layout
    assert tmsn_sgd_hybrid._base.program_record is tmsn_sgd_hybrid.program_record


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults_hybrid.SSM_FAULTS) + ["all_experts", "bias_out_of_choice"])
def test_check_fails_with_the_hybrid_path_broken(cell, fault):
    tiny = TINY["tmsn_sgd_hybrid"]
    with faults_hybrid.faults.FAULTS["tmsn_sgd_hybrid"][fault]():
        line, _ = run.run_cell(cell, 2 ** 31 + 77, 0.5, False, device="cpu", t_start=time.perf_counter(),
                               overrides={**tiny, "traffic": {**tiny["traffic"], "seq": 64}})
    out = json.loads(line)
    assert not out["correct"], (fault, out["checks"])
