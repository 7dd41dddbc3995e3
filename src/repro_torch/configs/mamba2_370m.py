"""mamba2-370m [arXiv:2405.21060; unverified] — SSD (state-space duality),
attention-free; decode is an O(1) state update so long_500k runs."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    param_dtype="float32",
    source="arXiv:2405.21060; unverified",
)
