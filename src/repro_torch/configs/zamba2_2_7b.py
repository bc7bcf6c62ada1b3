"""zamba2-2.7b [hybrid] -- Mamba2 backbone + SHARED attention block every 6
layers (weight sharing is the zamba2 design).  [arXiv:2411.15242; hf]

Sub-quadratic: runs long_500k; at 500k context the shared attention block
uses a 4096-token sliding window (prefill only: decode attends to the whole
cache, as in the JAX package) while the Mamba2 path carries unbounded-range
state.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_version=2, attn_every=6,
    subquadratic=True, window=4096,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                      vocab=256, ssm_state=8, attn_every=2, window=None)
