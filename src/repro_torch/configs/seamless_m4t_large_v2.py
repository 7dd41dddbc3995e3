"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec, multimodal.

"24L" is interpreted as 24 encoder + 24 decoder layers of the stated
geometry (consistent with the ~2.3B public checkpoint).  The audio
frontend is a stub: input_specs() supplies precomputed frame embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    encoder_layers=24, decoder_layers=24,
    frontend="audio_frames", param_dtype="bfloat16",
    source="arXiv:2308.11596; hf",
)
