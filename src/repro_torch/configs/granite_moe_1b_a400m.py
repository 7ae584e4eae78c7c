"""IBM Granite-3.0 1B-a400m MoE base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d=1024, 16 heads (GQA kv=8), 32 experts top-8 with d_expert=512.
"""
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49_155,
    act="silu", glu=True, pos="rope", rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoECfg(num_experts=32, top_k=8, d_expert=512, every=1),
    max_seq=32_768,
    notes="fine-grained experts (32e top-8); full attention => long_500k skipped",
)
