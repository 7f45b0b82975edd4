"""Granite-3.0 8B (GQA)  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155,
    block_pattern=("attn",),
    source="hf:ibm-granite/granite-3.0-8b-base",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=256)
