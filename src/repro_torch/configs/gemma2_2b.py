"""Gemma-2 2B [arXiv:2408.00118] — alternating local(4096)/global layers,
attention + final-logit softcaps, pre+post RMSNorms, head_dim=256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    act="gelu", glu=True, pos="rope", embed_scale=True, post_norms=True,
    attn_softcap=50.0, logit_softcap=30.0,
    local_global_pattern=2, window=4096,
    tie_embeddings=True,
    max_seq=32_768,
    notes="alternating global layers keep it quadratic => long_500k skipped",
)
