"""DeepSeek-V2-Lite (16B total / 2.4B active)  [arXiv:2405.04434; hf]

Assignment header says "MoE 64e top-6 - 2 shared + 160 routed"; the
published V2-Lite config is 64 routed / top-6 / 2 shared (160 routed
belongs to full V2) — we implement the headline 64e (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    block_pattern=("mla_moe",),
    moe=MoECfg(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256,
        moe=MoECfg(num_experts=8, top_k=2, num_shared=1, d_expert=96),
        mla=MLACfg(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                   qk_rope_dim=8, v_head_dim=16))
