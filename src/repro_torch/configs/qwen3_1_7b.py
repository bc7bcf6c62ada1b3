"""qwen3-1.7b [dense] -- qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                      vocab=256, head_dim=16)
