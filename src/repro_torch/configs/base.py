"""Architecture config dataclass + the input-shape suite.

The port of ``repro.configs.base``: the same ``ArchConfig`` fields and
defaults, the same four input-shape cells (train_4k / prefill_32k /
decode_32k / long_500k).  ``input_specs`` gives meta tensors (shape and
dtype, no storage) where the reference gives ``jax.ShapeDtypeStruct``s,
and ``param_count`` inits the model on the meta device where the
reference uses ``jax.eval_shape``: neither allocates anything.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | vlm | hybrid | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_scale: Optional[float] = None
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    window: int = 0                # sliding-window width (0 = none)
    pattern: str = "global"        # global | gemma3 (5:1) | swa
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    router_fn: str = "softmax"     # softmax | sigmoid
    moe_cf: float = 1.25           # capacity factor
    moe_aux_alpha: float = 0.01
    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False              # multi-token prediction head
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (recurrentgemma)
    lru_width: int = 0
    conv_width: int = 4
    # enc-dec (whisper)
    encoder_layers: int = 0
    n_frames: int = 0
    # vlm
    num_image_tokens: int = 0
    vit_dim: int = 0
    # misc
    mlp_act: str = "silu"          # silu | gelu
    tie_embeddings: bool = False
    scale_embed: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"   # master param dtype
    q_chunk: int = 512             # flash-attention q block
    kv_chunk: int = 1024           # flash-attention kv block
    remat: str = "full"            # none | full | dots  (train-time only)
    # ---- perf levers (the reference's §Perf; defaults kept) ----
    attn_compute_dtype: str = "float32"  # float32 | bfloat16 (score/p dtype)
    causal_skip: bool = False      # skip fully-masked kv chunks
    cache_update: str = "where"    # where | scatter (decode cache insert)
    tp_psum: bool = False          # sharded form only (ROADMAP A.14)
    # training schedule (minicpm uses WSD)
    lr_schedule: str = "cosine"    # cosine | wsd

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    # convenience ------------------------------------------------------
    def param_count(self) -> int:
        """Parameter count (total; for MoE also see active), from an init
        on the meta device: shapes only, nothing allocated."""
        from ..models import api
        from ..models.common import tree_leaves
        params = api.get_model(self).init(device="meta")
        return sum(math.prod(l.shape) for l in tree_leaves(params))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k experts)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = 3 * self.d_model * self.moe_d_ff
        inactive = (self.n_experts - self.top_k) * per_expert \
            * self.num_layers
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs for which long_500k is runnable (sub-quadratic context cost);
#: pure full-attention archs skip it per the assignment spec.
LONG_CONTEXT_OK = ("mamba2-780m", "recurrentgemma-9b")


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "full-attention arch; long_500k skipped per spec"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins (shape and dtype, no storage) for the model
    inputs of one cell."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((b, s), i32)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": spec((b, 1), i32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patches"] = spec((b, cfg.num_image_tokens, cfg.vit_dim),
                                torch.bfloat16)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frames"] = spec((b, cfg.n_frames, cfg.d_model),
                               torch.bfloat16)
    return specs


def extra_input_specs(cfg: ArchConfig, batch: int = 1
                      ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Named non-token inputs a family's prefill consumes, as
    ``name -> ((batch,)+shape, dtype)``.  The serving scheduler fills
    these with zeros when a request does not supply them, and the
    "engine" executable's Signature lists them."""
    if cfg.family == "audio":
        return {"frames": ((batch, cfg.n_frames, cfg.d_model), "float32")}
    if cfg.family == "vlm":
        return {"patches": ((batch, cfg.num_image_tokens, cfg.vit_dim),
                            "float32")}
    return {}
