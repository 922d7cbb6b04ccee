"""Model FLOPs of a training step of DeepSeek-V3's block on one chip's
share of the experts (MLA, a leading dense layer, MoE layers with shared
and routed experts), without remat's recompute.

Per token and layer: MLA in its expanded form (the q projection, the
latent down-projection, ``kv_b``'s up-projection of the latent to each
head's no-position key and value, the output projection, and the scores
and the weighted sum over the causal average context s/2 with the query
and key at nope + rope and the value at v); a dense layer's SwiGLU; an
MoE layer's router over all E experts, its shared experts' SwiGLU, and
the held experts' SwiGLUs at the balanced expectation of the choices
routed here, k x held / E a token. The logits' product once a token;
forward, then twice that in the backward. The embedding's gather, the
norms and the elementwise work are not counted."""


def attention_flops(d_model: int, num_heads: int, q_dim: int, v_dim: int, kv_lora_rank: int, rope_dim: int,
                    nope_dim: int, s_ctx: float) -> float:
    """One token of one MLA layer, forward: projections and attention."""
    H = num_heads
    proj = 2 * d_model * H * q_dim + 2 * d_model * (kv_lora_rank + rope_dim) \
        + 2 * kv_lora_rank * H * (nope_dim + v_dim) + 2 * H * v_dim * d_model
    return proj + 2 * s_ctx * H * q_dim + 2 * s_ctx * H * v_dim


def forward_flops(*, d_model: int, num_heads: int, qk_nope_head_dim: int, qk_rope_head_dim: int,
                  v_head_dim: int, kv_lora_rank: int, d_ff: int, moe_d_ff: int, num_experts: int,
                  num_experts_per_tok: int, num_shared_experts: int, experts_held: int, first_k_dense: int,
                  num_layers: int, vocab: int, batch: int, seq: int) -> float:
    tokens = batch * seq
    attn = attention_flops(d_model, num_heads, qk_nope_head_dim + qk_rope_head_dim, v_head_dim, kv_lora_rank,
                           qk_rope_head_dim, qk_nope_head_dim, seq / 2.0)
    dense = attn + 2 * d_model * d_ff * 3
    routed = num_experts_per_tok * experts_held / num_experts
    moe = attn + 2 * d_model * num_experts + (num_shared_experts + routed) * 2 * d_model * moe_d_ff * 3
    per_token = first_k_dense * dense + (num_layers - first_k_dense) * moe + 2 * d_model * vocab
    return tokens * per_token


def train_step_flops(**shape) -> float:
    """Forward and backward: three times the forward."""
    return 3.0 * forward_flops(**shape)


def expert_mm_flops(rows: int, d_model: int, moe_d_ff: int, passes: int) -> float:
    """The held experts' grouped products over ``rows`` token-choices:
    three products of 2 x d x f a row and pass (gate, up, down)."""
    return 6.0 * rows * d_model * moe_d_ff * passes
