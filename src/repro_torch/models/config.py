"""Architecture configuration for the LM model zoo."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2.5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False            # arctic: parallel dense FFN branch
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1                    # 1 = mamba1, 2 = mamba2 (SSD)
    ssm_heads: int = 0                      # mamba2 heads (0 => derived)
    # --- hybrid (zamba2): one SHARED attention block applied every
    #     attn_every ssm layers (weight sharing is the zamba2 design) ---
    attn_every: int = 0
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                    # precomputed frame embeddings (stub)
    # --- vlm (internvl) ---
    n_patches: int = 0                      # precomputed patch embeddings (stub)
    # --- common ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    window: Optional[int] = None            # sliding-window attention
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"                # adamw | adafactor | sgdm
    # long-context applicability: can run long_500k
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))

    @property
    def mamba2_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (for CPU smoke tests)."""
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv)
        mlp = 3 * d * self.d_ff
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + mlp
        elif self.family == "moe":
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            per_layer = attn + moe + (3 * d * self.d_ff if self.dense_residual else 0)
        elif self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per_layer = d * 2 * di + di * self.ssm_conv + \
                di * (self.dt_rank + 2 * ns) + self.dt_rank * di + di * d + di * ns
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            nh = self.mamba2_heads
            per_layer = d * (2 * di + 2 * ns + nh) + di * self.ssm_conv + di * d
        total = self.n_layers * per_layer + self.vocab * d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp)
        if self.family == "hybrid" and self.attn_every:
            total += attn + mlp                     # one shared block
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ModelConfig):
    """long_500k needs sub-quadratic attention (ssm / hybrid archs)."""
    return tuple(s for s in ALL_SHAPES
                 if s.name != "long_500k" or cfg.subquadratic)
