"""Yi-34B (llama-arch GQA)  [arXiv:2403.04652; hf]

56 q-heads / 8 kv-heads do not divide the 16-way TP axis: the physical
layout pads to 64 q / 16 kv slots (see models/tp_padding.py).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    block_pattern=("attn",),
    source="arXiv:2403.04652",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=7,
                          num_kv_heads=1, head_dim=16, d_ff=128,
                          vocab_size=256)
