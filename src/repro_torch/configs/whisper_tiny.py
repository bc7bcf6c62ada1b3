"""whisper-tiny [audio] -- enc-dec, conv frontend STUB.  [arXiv:2212.04356; unverified]

The modality frontend is a stub: the caller provides precomputed frame
embeddings (B, encoder_seq, d_model) in place of the log-mel + conv stem.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536,
    vocab=51865, encoder_layers=4, encoder_seq=1500,
)

SMOKE = CONFIG.scaled(n_layers=2, encoder_layers=2, d_model=48, n_heads=3,
                      n_kv=3, d_ff=96, vocab=256, encoder_seq=64)
