"""Whisper small [arXiv:2212.04356] — encoder-decoder backbone.  The conv
audio frontend is STUBBED: input_specs() provides precomputed frame
embeddings; the decoder is a standard causal LM with cross-attention."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51_865,
    act="gelu", glu=False, norm="layernorm", pos="learned", qkv_bias=True,
    tie_embeddings=True, encoder_layers=12,
    max_seq=32_768,
    notes="enc-dec: decode cells run (decoder KV + cross cache); long skipped",
)
