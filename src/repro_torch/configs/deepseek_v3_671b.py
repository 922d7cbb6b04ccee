"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed,
top-8) + MTP [arXiv:2412.19437]. First 3 layers dense."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: latent cache, kv head count nominal
    d_ff=18432,              # dense-layer FFN
    moe_d_ff=2048,           # per routed expert
    vocab=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    first_k_dense=3,
    mtp_depth=1,
    citation="arXiv:2412.19437",
)
