"""LLaVA-NeXT-34B backbone  [hf:llava-hf/llava-v1.6-34b-hf; unverified]

Yi-34B-shaped LM backbone; the anyres vision tower is a STUB — the
model consumes precomputed patch embeddings (B, 576, d_model) that
occupy the first positions of the sequence (masked out of the loss).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    block_pattern=("attn",),
    frontend="vision_patches", num_patches=576,
    source="hf:llava-hf/llava-v1.6-34b-hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=7,
                          num_kv_heads=1, head_dim=16, d_ff=128,
                          vocab_size=256, num_patches=8)
