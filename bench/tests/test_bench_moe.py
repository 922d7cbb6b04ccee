"""The MoE cells' own pieces: the layout against the program's tree, the
FLOP count by hand, the Zipf draw, the routing comparison, and each MoE
fault found by the check on the CPU at a tiny size. Importing this file
adds the MoE system's tiny shapes to ``conftest.TINY`` and its faults to
``faults.FAULTS`` (``faults_moe.py``), which the rehearsal tests of every
cell read."""

import json
import time

import pytest
from conftest import TINY

import faults_moe
import run
from counts import moe_mla
from harness import core

TINY.setdefault("tmsn_sgd_moe", {
    "config": {"arch": {
        "name": "tiny-moe", "arch_type": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 4, "d_ff": 128, "moe_d_ff": 32, "vocab": 256, "attention": "mla", "q_lora_rank": 0, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "num_experts": 16,
        "num_experts_per_tok": 4, "num_shared_experts": 2, "first_k_dense": 1, "router_score": "sigmoid",
        "routed_scaling_factor": 2.446, "router_bias_rate": 0.001, "router_aux_coef": 0.0001,
        "moe_dispatch": "dropless", "experts_held": 4, "experts_offset": 0, "rope_theta": 50000.0,
        "norm_eps": 1e-5, "tie_embeddings": False, "mlp_gated": True, "mtp_depth": 0,
        "param_dtype": "float32", "compute_dtype": "float32", "remat": True}},
    "traffic": {"batch": 2, "seq": 16, "traced_rounds": 1}})

MAN = core.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]
         if core.cell_files(MAN, w["name"])[2]["system"] == "tmsn_sgd_moe"]


def _cfg(cell):
    return core.cell_files(MAN, cell)[2]


@pytest.mark.parametrize("cell", CELLS)
def test_layout_is_the_programs_tree_at_the_committed_widths(cell):
    from harness import lm_inputs
    from repro_torch.models import init_params
    from repro_torch.models.config import ArchConfig
    from systems import tmsn_sgd_moe

    arch = _cfg(cell)["arch"]
    have = [(n, tuple(t.shape)) for n, t in lm_inputs.flatten(
        init_params(ArchConfig(**arch), 0, device="meta")).items()]
    assert have == [(n, tuple(s)) for n, s, _ in tmsn_sgd_moe.layout(arch)]
    assert sum(__import__("math").prod(s) for _, s in have) == 568_484_608


@pytest.mark.parametrize("cell", CELLS)
def test_config_keeps_the_published_numbers_but_the_cut(cell):
    cfg, a = _cfg(cell), _cfg(cell)["arch"]
    pairs = {"hidden_size": "d_model", "num_attention_heads": "num_heads", "intermediate_size": "d_ff",
             "moe_intermediate_size": "moe_d_ff", "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "n_routed_experts": "num_experts", "num_experts_per_tok":
             "num_experts_per_tok", "n_shared_experts": "num_shared_experts", "first_k_dense_replace":
             "first_k_dense", "routed_scaling_factor": "routed_scaling_factor", "rms_norm_eps": "norm_eps",
             "rope_theta": "rope_theta", "num_hidden_layers": "num_layers", "vocab_size": "vocab",
             "experts_held": "experts_held"}
    assert all(cfg[k] == a[v] for k, v in pairs.items())
    assert cfg["scoring_func"] == a["router_score"] == "sigmoid" and a["moe_dispatch"] == "dropless"
    assert {k for k, v in cfg["published"].items() if cfg[k] != v} == {"num_hidden_layers", "vocab_size",
                                                                       "experts_held"}


def test_flops_by_hand():
    # d 8, 2 heads, nope 4 + rope 2, v 4, rank 4; dense 16, expert 8, E 4, k 2, 1 shared, 2 held;
    # 1 dense + 1 MoE layer, vocab 10, 1 x 4 tokens
    proj = 2 * 8 * 2 * 6 + 2 * 8 * (4 + 2) + 2 * 4 * 2 * (4 + 4) + 2 * 2 * 4 * 8
    attn = proj + 2 * 2.0 * 2 * 6 + 2 * 2.0 * 2 * 4
    dense = attn + 2 * 8 * 16 * 3
    moe = attn + 2 * 8 * 4 + (1 + 2 * 2 / 4) * 2 * 8 * 8 * 3
    want = 4 * (dense + moe + 2 * 8 * 10)
    shape = dict(d_model=8, num_heads=2, qk_nope_head_dim=4, qk_rope_head_dim=2, v_head_dim=4, kv_lora_rank=4,
                 d_ff=16, moe_d_ff=8, num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
                 experts_held=2,
                 first_k_dense=1, num_layers=2, vocab=10, batch=1, seq=4)
    assert moe_mla.forward_flops(**shape) == want
    assert moe_mla.train_step_flops(**shape) == 3 * want
    assert moe_mla.expert_mm_flops(10, 8, 4, 4) == 6 * 10 * 8 * 4 * 4


def test_zipf_tokens_repeat_and_follow_the_rank_law():
    import torch

    from systems.tmsn_sgd_moe import zipf_tokens

    cpu = torch.device("cpu")
    a, b, c = (zipf_tokens(s, 1, 0, (4, 4096), 1000, 1.0, cpu) for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 1000
    freq = torch.bincount(a.reshape(-1).long(), minlength=1000).double() / a.numel()
    harmonic = sum(1.0 / r for r in range(1, 1001))
    assert abs(float(freq[0]) - 1 / harmonic) < 0.01 and abs(float(freq[1]) - 0.5 / harmonic) < 0.01


def test_route_mismatch_counts_choices_the_other_side_did_not_make():
    import torch

    from systems.tmsn_sgd_moe import route_mismatch

    got = [torch.tensor([[0, 1], [2, 3]]), torch.tensor([[4, 5], [6, 7]])]
    want = torch.stack([torch.tensor([[1, 0], [2, 4]]), torch.tensor([[4, 5], [6, 7]])])
    assert route_mismatch(got, want, 8) == 1 / 8
    assert route_mismatch(got[:1], want, 8) == float("inf")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults_moe.MOE_FAULTS))
def test_check_fails_with_the_moe_path_broken(cell, fault):
    """At 2 x 64 tokens, so that the Zipf ids load some held expert past
    the capacity."""
    tiny = TINY["tmsn_sgd_moe"]
    with faults_moe.MOE_FAULTS[fault]():
        line, _ = run.run_cell(cell, 2 ** 31 + 77, 0.5, False, device="cpu", t_start=time.perf_counter(),
                               overrides={**tiny, "traffic": {**tiny["traffic"], "seq": 64}})
    out = json.loads(line)
    assert not out["correct"], (fault, out["checks"])
