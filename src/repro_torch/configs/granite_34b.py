"""IBM Granite 34B code model [arXiv:2405.04324] — GPT-BigCode style:
MQA (kv=1), non-GLU GELU MLP, LayerNorm, learned absolute positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24_576, vocab=49_152,
    act="gelu", glu=False, norm="layernorm", pos="learned", qkv_bias=True,
    tie_embeddings=True,
    max_seq=32_768,
    notes="MQA; learned positions sized to 32k for the prefill cell",
)
