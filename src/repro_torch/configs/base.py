"""Architecture + input-shape configuration system.

Every assigned architecture is an `ArchConfig`; every benchmark shape is a
`ShapeSpec`.  `applicable()` encodes the spec's skip rules (long_500k needs
sub-quadratic sequence handling; decode shapes need a decoder).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "applicable", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int               # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // num_heads

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    d_ff_dense: int = 0               # width of that dense residual FFN
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 2048

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (zamba2): one *shared* attention block applied every k layers
    shared_attn_every: int = 0

    # encoder-decoder (seamless)
    encoder_layers: int = 0
    decoder_layers: int = 0

    # modality frontend stubs
    frontend: str = "none"       # none | audio_frames | vision_patches
    num_patch_tokens: int = 0    # vlm: positions carrying patch embeddings

    # misc
    norm: str = "rmsnorm"
    activation: str = "silu"
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    param_dtype: str = "float32"      # big archs use bfloat16
    opt_moment_dtype: str = "float32" # arctic uses bfloat16 (halves its moments)
    attn_chunk: int = 1024            # query-chunked attention block size
    loss_chunk: int = 512             # sequence chunk for the xent loss
    unroll_layers: bool = False       # python-loop layers (roofline compiles)
    # --- perf knobs (hillclimbed in EXPERIMENTS.md §Perf) ---
    remat_policy: str = "nothing"     # nothing | dots | none
    attn_causal_unroll: bool = False  # skip fully-masked KV blocks (python
                                      # loop over q chunks, ~2x fewer attn flops)
    sharding_profile: str = "tp"      # tp | dp (dp: replicate weights, use
                                      # the model axis as extra batch axis)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | float8_e4m3fn (2x smaller
                                      # KV stream for memory-bound decode)
    source: str = ""                  # provenance tag [source; tier]

    def __post_init__(self):
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "encdec" and not self.encoder_layers:
            object.__setattr__(self, "encoder_layers", self.num_layers)
            object.__setattr__(self, "decoder_layers", self.num_layers)

    def padded_vocab(self) -> int:
        """Embedding/head vocab padded for sharding divisibility (16-way TP
        x possible 16-way FSDP). Pad ids are masked out of the loss."""
        return ((self.vocab_size + 255) // 256) * 256

    # ---- analytics used by the roofline report ----
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            num_layers=max(2, min(3, self.num_layers)),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(2, self.num_kv_heads) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            param_dtype="float32",
            attn_chunk=32,
            loss_chunk=32,
            moe_group_size=32,
        )
        if self.num_experts:
            kw.update(num_experts=4, num_experts_per_tok=2,
                      num_shared_experts=min(1, self.num_shared_experts),
                      d_ff_dense=64 if self.moe_dense_residual else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2, num_layers=4)
        if self.family == "encdec":
            kw.update(encoder_layers=2, decoder_layers=2)
        if self.num_patch_tokens:
            kw.update(num_patch_tokens=8)
        return ArchConfig(**kw)


def _ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_dim


def _param_count(cfg: ArchConfig, active_only: bool) -> int:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += d * v  # head
    hd = cfg.head_dim
    attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + cfg.num_heads * hd * d
    mlp3 = 3 * d * ff  # SwiGLU w1,w3,w2

    def ssm_block():
        d_inner, nheads, conv_dim = _ssm_dims(cfg)
        in_proj = d * (2 * d_inner + 2 * cfg.ssm_state + nheads)
        return in_proj + cfg.ssm_conv * conv_dim + d_inner * d + 3 * nheads + d_inner

    if cfg.family in ("dense", "vlm"):
        total += cfg.num_layers * (attn + mlp3)
    elif cfg.family == "moe":
        e_used = cfg.num_experts_per_tok if active_only else cfg.num_experts
        moe = e_used * 3 * d * ff + d * cfg.num_experts
        moe += cfg.num_shared_experts * 3 * d * ff
        if cfg.moe_dense_residual:
            moe += 3 * d * (cfg.d_ff_dense or ff)
        total += cfg.num_layers * (attn + moe)
    elif cfg.family == "ssm":
        total += cfg.num_layers * ssm_block()
    elif cfg.family == "hybrid":
        total += cfg.num_layers * ssm_block()
        n_shared = cfg.num_layers // max(1, cfg.shared_attn_every)
        shared = 2 * d * d + attn + mlp3  # in-proj(2d->d) + attn + mlp
        total += shared if not active_only else shared * 1  # weights shared
        if active_only:
            total += 0
    elif cfg.family == "encdec":
        enc = cfg.encoder_layers * (attn + mlp3)
        dec = cfg.decoder_layers * (2 * attn + mlp3)  # self + cross
        total += enc + dec
    return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeSpec":
        return ShapeSpec(self.name, self.kind, seq_len=64, global_batch=2)


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("pure full-attention architecture: 512k-token decode requires "
                "sub-quadratic attention (spec: skip and note in DESIGN.md)")
    return None


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None
