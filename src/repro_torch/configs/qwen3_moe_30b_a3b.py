"""qwen3-moe-30b-a3b [moe] -- 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=768,
    vocab=151936, head_dim=64, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=32,
                      vocab=256, head_dim=16, n_experts=8, top_k=2)
