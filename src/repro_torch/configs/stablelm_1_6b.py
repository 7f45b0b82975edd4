"""StableLM-2-1.6B  [hf:stabilityai/stablelm-2-1_6b; unverified]
(full RoPE used instead of partial-rotary 25% — noted simplification)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    block_pattern=("attn",),
    source="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, d_ff=128, vocab_size=256)
