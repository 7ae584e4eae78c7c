"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay linear recurrence; O(1)-state decode => runs the long_500k cell."""
from repro_torch.models.config import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65_536,
    pos="none", tie_embeddings=False,
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32),
    max_seq=1_048_576, supports_long_context=True,
    notes="attention-free; TCQ technique inapplicable (no attention sharding)",
)
