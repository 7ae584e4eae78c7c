"""Qwen2-VL 72B backbone [arXiv:2409.12191].

80L, d=8192, 64 heads (GQA kv=8), d_ff=29568, vocab 152064.  M-RoPE with
temporal/height/width position streams; dynamic-resolution vision frontend is
STUBBED — input_specs() feeds precomputed patch embeddings + (3,B,S) positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29_568, vocab=152_064,
    act="silu", glu=True, pos="mrope", rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), qkv_bias=True,
    tie_embeddings=False, input_mode="embeds",
    max_seq=32_768,
    notes="M-RoPE VLM backbone, patch embeds stubbed; long_500k skipped",
)
