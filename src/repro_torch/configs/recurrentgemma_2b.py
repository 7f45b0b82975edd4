"""RecurrentGemma-2B (Griffin)  [arXiv:2402.19427; hf]

RG-LRU recurrent blocks + sliding-window local attention at 1:2
(pattern rglru, rglru, local_attn); MQA (kv=1), window 2048.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    attention_window=2048, rnn_state_dim=2560, conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=3, d_model=64, num_heads=2,
                          num_kv_heads=1, head_dim=32, d_ff=128,
                          vocab_size=256, attention_window=16,
                          rnn_state_dim=64)
