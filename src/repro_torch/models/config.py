"""Architecture config schema + the layer-pattern machinery; a copy of
``src/repro/models/config.py`` (framework-neutral), kept here so the
port imports nothing of the reference.

An ``ArchConfig`` fully determines a model. Heterogeneous stacks
(gemma3's 5 local : 1 global, deepseek's first-k-dense, zamba2's shared
attention) are expressed as *segments*: a repeating unit of
``LayerSpec``s scanned ``repeats`` times. Each unit-position gets its
own stacked parameters (leading dim = repeats); ``shared_attn`` layers
reference one un-stacked param set (true weight sharing, as in Zamba2).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn", "moe", "ssm", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind = "attn"
    window: int | None = None  # sliding-window size (None = full attention)
    cross_attention: bool = False  # decoder layer with cross-attn (enc-dec)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""

    head_dim: int | None = None  # default d_model // num_heads
    attention: str = "gqa"  # gqa | mla
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_gated: bool = True  # SwiGLU (True) vs GELU 2-matrix MLP (False)

    # sliding-window pattern (gemma3): every `local_ratio` local layers
    # followed by 1 global layer; window applies to local layers.
    sliding_window: int | None = None
    local_ratio: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int | None = None
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MTP (DeepSeek-V3 multi-token prediction) — extra predict depth
    mtp_depth: int = 0

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every
    # `shared_attn_every` ssm layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0

    # modality frontend stub (audio frames / vision patches)
    frontend: str | None = None  # "audio" | "vision"
    frontend_len: int = 0
    frontend_dim: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    # capabilities
    supports_long_decode: bool = False  # sub-quadratic decode at 500k

    # --- §Perf hillclimb knobs (baseline = all off; see EXPERIMENTS.md) ---
    #: re-anchor activation sharding at every layer-scan step (fixes
    #: batch-sharding loss inside while bodies -> replicated-batch temps)
    act_dp: tuple[str, ...] | None = None
    #: pad embedding/lm_head vocab to a multiple (0 = off); enables
    #: vocab-dim sharding for vocabs not divisible by the mesh axis
    vocab_pad_multiple: int = 0
    #: ring-buffer KV caches sized to the window for sliding-window
    #: layers (512x capacity cut on gemma3 long_500k — §Perf)
    windowed_cache: bool = False

    # analysis-mode knobs (dry-run cost extrapolation; see launch/dryrun.py):
    # unroll segment scans so XLA cost analysis sees every layer, and
    # override per-segment repeat counts (decoder, then encoder).
    scan_unroll: bool = False
    reps_override: tuple[int, ...] | None = None
    enc_reps_override: tuple[int, ...] | None = None

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def padded_vocab(self) -> int:
        if not self.vocab_pad_multiple:
            return self.vocab
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m


def layer_segments(cfg: ArchConfig) -> list[tuple[list[LayerSpec], int]]:
    """Decoder-stack segments: list of (unit, repeats).

    The unit is scanned `repeats` times; ``sum(len(unit)*reps) ==
    cfg.num_layers`` counting only parameterized-per-layer specs
    (``shared_attn`` applications are extra, weight-shared).
    """
    segs: list[tuple[list[LayerSpec], int]] = []
    segs = _base_segments(cfg)
    if cfg.reps_override is not None:
        assert len(cfg.reps_override) == len(segs), (cfg.name, cfg.reps_override, len(segs))
        segs = [(u, r) for (u, _), r in zip(segs, cfg.reps_override)]
    return segs


def _base_segments(cfg: ArchConfig) -> list[tuple[list[LayerSpec], int]]:
    segs: list[tuple[list[LayerSpec], int]] = []
    if cfg.arch_type == "ssm":
        segs.append(([LayerSpec(kind="ssm")], cfg.num_layers))
    elif cfg.arch_type == "hybrid":
        k = cfg.shared_attn_every or 6
        full, rem = divmod(cfg.num_layers, k)
        if full:
            unit = [LayerSpec(kind="ssm")] * k + [LayerSpec(kind="shared_attn")]
            segs.append((unit, full))
        if rem:
            segs.append(([LayerSpec(kind="ssm")] * rem, 1))
    elif cfg.num_experts > 0:
        if cfg.first_k_dense:
            segs.append(([LayerSpec(kind="attn")], cfg.first_k_dense))
        segs.append(([LayerSpec(kind="moe")], cfg.num_layers - cfg.first_k_dense))
    elif cfg.local_ratio:
        unit_len = cfg.local_ratio + 1
        full, rem = divmod(cfg.num_layers, unit_len)
        unit = [LayerSpec(kind="attn", window=cfg.sliding_window)] * cfg.local_ratio + [
            LayerSpec(kind="attn", window=None)
        ]
        if full:
            segs.append((unit, full))
        if rem:
            segs.append(([LayerSpec(kind="attn", window=cfg.sliding_window)] * rem, 1))
    else:
        cross = cfg.is_encdec()
        segs.append(([LayerSpec(kind="attn", cross_attention=cross)], cfg.num_layers))
    return segs


def encoder_segments(cfg: ArchConfig) -> list[tuple[list[LayerSpec], int]]:
    if not cfg.is_encdec():
        return []
    reps = cfg.encoder_layers
    if cfg.enc_reps_override is not None:
        reps = cfg.enc_reps_override[0]
    return [([LayerSpec(kind="attn")], reps)]


def validate(cfg: ArchConfig) -> None:
    assert cfg.num_heads % max(cfg.num_kv_heads, 1) == 0 or cfg.attention == "mla"
    if cfg.reps_override is None:
        n_param_layers = sum(
            reps * sum(1 for s in unit if s.kind != "shared_attn")
            for unit, reps in layer_segments(cfg)
        )
        assert n_param_layers == cfg.num_layers, (cfg.name, n_param_layers, cfg.num_layers)
    if cfg.num_experts:
        assert cfg.num_experts_per_tok > 0
    if cfg.attention == "mla":
        assert cfg.kv_lora_rank > 0 and cfg.qk_rope_head_dim > 0
