"""Jamba-1.5 Large 398B [arXiv:2403.19887] — hybrid Mamba:attention 7:1
interleave, MoE (16e top-2) every other layer.  SSM state decode => runs the
long_500k cell (the 9 attention layers use a model-axis-sharded KV cache).

Memory plan: optimizer=adafactor (factored second moment) — Adam fp32 m/v on
398B params would not fit 256 x 16GB; recorded in EXPERIMENTS §Dry-run."""
from repro_torch.models.config import MambaCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24_576, vocab=65_536,
    act="silu", glu=True, pos="none",  # jamba uses no positional encoding
    tie_embeddings=False,
    moe=MoECfg(num_experts=16, top_k=2, d_expert=24_576, every=2),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    max_seq=1_048_576, supports_long_context=True,
    optimizer="adafactor",
    n_micro_override=16,  # §Perf iteration: -38% temp memory, flat terms
)
