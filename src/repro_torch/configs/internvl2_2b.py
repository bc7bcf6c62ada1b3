"""internvl2-2b [vlm] -- InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

The ViT frontend is a STUB: the caller provides precomputed patch
embeddings (B, n_patches, d_model), which the LM consumes as a prefix; the
transformer backbone below is the InternLM2-side config.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192,
    vocab=92553, n_patches=1024,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                      vocab=256, n_patches=16)
