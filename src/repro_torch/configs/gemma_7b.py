"""Gemma 7B [arXiv:2403.08295] — GeGLU, head_dim=256, embed scaling."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24_576, vocab=256_000,
    act="gelu", glu=True, pos="rope", embed_scale=True,
    tie_embeddings=True,
    max_seq=32_768,
    notes="GeGLU; 256k vocab stresses the vocab-sharded embed/unembed",
)
