"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified] — pixtral-ViT
frontend (stubbed to precomputed patch embeddings) + mistral-nemo backbone."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1e6, frontend="vision_patches", num_patch_tokens=1024,
    param_dtype="bfloat16",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
