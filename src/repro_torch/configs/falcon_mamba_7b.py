"""falcon-mamba-7b [ssm] -- mamba1, attention-free.  [arXiv:2410.05355; unverified]

Sub-quadratic: runs long_500k (O(1)-state decode)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_ff=0,
    vocab=65024, ssm_state=16, ssm_version=1, subquadratic=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, vocab=256, ssm_state=4)
