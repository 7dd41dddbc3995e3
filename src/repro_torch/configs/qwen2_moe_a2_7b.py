"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 60 routed experts
top-4 + 4 shared experts.  60 % 16 != 0, so experts are padded to 64 for
expert-parallelism over the 16-way model axis (4 inert, router-masked)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    num_experts=60, num_experts_per_tok=4, num_shared_experts=4,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
