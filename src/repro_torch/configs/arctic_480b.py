"""arctic-480b [moe] -- 128 experts top-2 + dense residual branch.
[hf:Snowflake/snowflake-arctic-base; hf]

The config names Adafactor (factored second moment) as its optimizer, as
the JAX package's does; it matters only to the LM training slice.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    n_experts=128, top_k=2, dense_residual=True,
    optimizer="adafactor",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=48,
                      vocab=256, head_dim=16, n_experts=8, top_k=2)
