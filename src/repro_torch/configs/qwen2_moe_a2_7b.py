"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    block_pattern=("attn_moe",),
    moe=MoECfg(num_experts=60, top_k=4, num_shared=4, d_expert=1408),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=256,
        moe=MoECfg(num_experts=8, top_k=2, num_shared=2, d_expert=96))
