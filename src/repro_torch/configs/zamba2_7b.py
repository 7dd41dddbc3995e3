"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 backbone with a
*shared* attention block (one weight set) applied every 6th layer; the
shared block consumes concat(hidden, initial-embedding) per the paper."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    shared_attn_every=6,
    param_dtype="bfloat16",
    source="arXiv:2411.15242; unverified",
)
