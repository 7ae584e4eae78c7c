"""Llama-4 Scout 17B-active / 16-expert [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE with top-1 routed + always-on shared expert ("early fusion" of expert
streams).  48L, d=5120, 40 heads (GQA kv=8), d_ff(expert)=8192, vocab 202k.
"""
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048,
    act="silu", glu=True, pos="rope", rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoECfg(num_experts=16, top_k=1, d_expert=8192, every=1,
               shared_expert=True),
    max_seq=32_768,
    notes="MoE top-1 + shared expert; full attention => long_500k skipped",
)
