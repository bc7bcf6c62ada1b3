"""llama3.2-3b [dense] -- small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=128256, rope_theta=5e5,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=192,
                      vocab=256)
