"""llama3-8b [arXiv:2407.21783; unverified] — dense GQA, 128k vocab."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=5e5, param_dtype="bfloat16",
    source="arXiv:2407.21783; unverified",
)
