"""smollm-360m [dense] -- llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560,
    vocab=49152,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=60, n_heads=3, n_kv=1, d_ff=128,
                      vocab=256)
