"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf] — 128e top-2 MoE
with a dense residual MLP in parallel (arctic's dense+MoE hybrid design).

d_ff_dense is an approximation of arctic's ~10B dense component (the
public config interleaves a dense FFN alongside the routed experts).
Optimizer moments are bf16, half the f32 moments' memory, so that the
largest config's training state fits its mesh.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    num_experts=128, num_experts_per_tok=2,
    moe_dense_residual=True, d_ff_dense=8192,
    param_dtype="bfloat16", opt_moment_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
