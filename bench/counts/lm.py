"""Model FLOPs of a dense decoder's training step: a frozen copy of the
arithmetic of ``repro_torch/launch/analytic.py`` (``_attn_layer`` and
``step_counts`` for ``kind="train"``), without remat's recompute.

Per token and layer: the QKV and output projections, the gated MLP's
three products, and attention's QK^T and PV over the causal average
context s/2; the logits' product once per token; forward, then twice
that in the backward. The embedding's gather is not counted."""


def forward_flops(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int, d_ff: int, vocab: int,
                  num_layers: int, batch: int, seq: int, gated: bool = True) -> float:
    tokens = batch * seq
    s_ctx = seq / 2.0
    proj = 2 * d_model * (2 * num_heads * head_dim + 2 * num_kv_heads * head_dim)
    attn = 4 * s_ctx * num_heads * head_dim
    mlp = 2 * d_model * d_ff * (3 if gated else 2)
    per_layer = tokens * (proj + attn + mlp)
    return per_layer * num_layers + tokens * 2 * d_model * vocab


def train_step_flops(**shape) -> float:
    """Forward and backward: three times the forward."""
    return 3.0 * forward_flops(**shape)
