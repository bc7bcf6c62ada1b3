"""qwen2.5-3b [dense] -- GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv=2, d_ff=11008,
    vocab=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160,
                      vocab=256)
