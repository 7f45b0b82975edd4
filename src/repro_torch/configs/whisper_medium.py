"""Whisper-medium (enc-dec)  [arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers; the conv/log-mel frontend is a STUB —
`input_specs()` provides precomputed frame embeddings (B, 1500, d).
RoPE replaces the original sinusoidal/learned positions (noted
simplification).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    block_pattern=("attn_cross",),
    encoder_layers=24, encoder_seq=1500,
    frontend="audio_frames",
    source="arXiv:2212.04356",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, d_ff=128, vocab_size=256,
                          encoder_layers=2, encoder_seq=32)
