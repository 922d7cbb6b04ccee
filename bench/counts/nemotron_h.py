"""Model FLOPs of a training step of Nemotron-H's hybrid stack on one
chip's share of the experts (single-mixer blocks in a layer pattern:
Mamba-2 "M", the MoE "E", attention "*"), without remat's recompute.

Per token: a Mamba-2 block's in and out projections and the chunked
SSD's products as computed (the within-chunk C B^T over a whole chunk of
Q positions in each group, its weighted sum of x over Q positions in
each head, the chunk's state and the entering state's read-out); an MoE
block's router over all E experts, its shared expert and the held
experts at the balanced expectation of the choices routed here, k x held
/ E a token, each relu^2 expert two products; an attention block's
projections and the scores and weighted sum over the causal average
context s/2. The logits' product once a token; forward, then twice that
in the backward. The conv, the norms, the embedding's gather and the
elementwise work are not counted."""


def ssm_flops(d_model: int, ssm_heads: int, ssm_head_dim: int, ssm_state: int, ssm_groups: int,
              ssm_chunk: int) -> float:
    """One token of one Mamba-2 block, forward."""
    H, P, N, G, Q = ssm_heads, ssm_head_dim, ssm_state, ssm_groups, ssm_chunk
    di = H * P
    proj = 2 * d_model * (2 * di + 2 * G * N + H) + 2 * di * d_model
    return proj + 2 * Q * G * N + 2 * Q * H * P + 2 * H * N * P * 2


def moe_flops(d_model: int, moe_d_ff: int, num_experts: int, num_experts_per_tok: int,
              num_shared_experts: int, experts_held: int) -> float:
    """One token of one MoE block, forward."""
    routed = num_experts_per_tok * experts_held / num_experts
    return 2 * d_model * num_experts + (num_shared_experts + routed) * 2 * d_model * moe_d_ff * 2


def attention_flops(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int, s_ctx: float) -> float:
    """One token of one attention block, forward."""
    proj = 2 * d_model * (num_heads + 2 * num_kv_heads) * head_dim + 2 * num_heads * head_dim * d_model
    return proj + 4 * s_ctx * num_heads * head_dim


def forward_flops(*, pattern: str, d_model: int, ssm_heads: int, ssm_head_dim: int, ssm_state: int,
                  ssm_groups: int, ssm_chunk: int, num_heads: int, num_kv_heads: int, head_dim: int,
                  moe_d_ff: int, num_experts: int, num_experts_per_tok: int, num_shared_experts: int,
                  experts_held: int, vocab: int, batch: int, seq: int) -> float:
    per = {"M": ssm_flops(d_model, ssm_heads, ssm_head_dim, ssm_state, ssm_groups, min(ssm_chunk, seq)),
           "E": moe_flops(d_model, moe_d_ff, num_experts, num_experts_per_tok, num_shared_experts,
                          experts_held),
           "*": attention_flops(d_model, num_heads, num_kv_heads, head_dim, seq / 2.0)}
    return batch * seq * (sum(per[c] for c in pattern) + 2 * d_model * vocab)


def train_step_flops(**shape) -> float:
    """Forward and backward: three times the forward."""
    return 3.0 * forward_flops(**shape)


def expert_mm_flops(rows: int, d_model: int, moe_d_ff: int, passes: int) -> float:
    """The held relu^2 experts' grouped products over ``rows``
    token-choices: two products of 2 x d x f a row and pass (up, down)."""
    return 4.0 * rows * d_model * moe_d_ff * passes
