"""Architecture + shape configuration dataclasses.

Every assigned architecture gets one module in this package exporting a
``CONFIG`` (the exact published configuration) and a ``reduced()``
function (a tiny same-family config for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int          # routed experts
    top_k: int
    num_shared: int = 0       # shared (always-on) experts
    d_expert: int = 0         # expert hidden dim (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0      # 0 -> no query compression (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    # Per-layer block pattern, cycled over num_layers.
    #   "attn"       dense GQA attention + MLP
    #   "mla"        multi-head latent attention + MLP/MoE
    #   "local_attn" windowed GQA attention + MLP
    #   "rglru"      RG-LRU recurrent block + MLP
    #   "mlstm"      matrix-LSTM block (self-contained projections)
    #   "slstm"      scalar-LSTM block (self-contained projections)
    block_pattern: Tuple[str, ...] = ("attn",)
    attention_window: int = 0         # for local_attn
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    # Encoder-decoder (whisper): encoder_layers > 0 adds a non-causal
    # encoder stack and cross-attention in the decoder.
    encoder_layers: int = 0
    encoder_seq: int = 1500           # precomputed frame embeddings
    # Modality frontend stub: None | "vision_patches" | "audio_frames"
    frontend: Optional[str] = None
    num_patches: int = 576            # vision_patches per image
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    rnn_state_dim: int = 0            # rglru recurrent width (0 -> d_model)
    conv_width: int = 4               # rglru temporal-conv width
    source: str = ""                  # provenance tag

    @property
    def kq_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def supports_long_context(self) -> bool:
        """True when no layer needs an unbounded full-attention cache."""
        return all(t in ("rglru", "mlstm", "slstm", "local_attn")
                   for t in self.layer_types())

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


# The assigned LM-family shape set (identical across the 10 archs).
SHAPES = {
    "train_4k":    ShapeCfg("train_4k",    "train",  4_096,   256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeCfg("decode_32k",  "decode", 32_768,  128),
    "long_500k":   ShapeCfg("long_500k",   "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether (arch x shape) is a live dry-run cell, with the reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("full-attention arch: 512k KV cache is quadratic-"
                       "attention territory; skipped per assignment note")
    return True, ""
