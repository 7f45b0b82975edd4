"""xLSTM-350M  [arXiv:2405.04517; unverified]

sLSTM + mLSTM blocks; d_ff=0 in the assignment means the blocks carry
their own up/down projections. We alternate mLSTM/sLSTM 1:1 (the 350M
xLSTM[1:1] variant); blocks are self-contained per the paper.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=2,
                          num_kv_heads=2, vocab_size=256)
