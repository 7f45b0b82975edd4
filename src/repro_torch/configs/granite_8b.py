"""Granite-8B-Code (llama-arch)  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    block_pattern=("attn",),
    source="arXiv:2405.04324",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=256)
