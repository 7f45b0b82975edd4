"""The paper's own GPT model family (§8.1 Table 3 workloads).

These drive the TrainMover runtime benchmarks (state-transfer sizes,
checkpoint sizes, warm-up costs). Configs follow GPT-3 table scaling
[Brown et al.] and the paper's named sizes.
"""
from repro_torch.configs.base import ArchConfig, MoECfg


def _gpt(name, L, d, H, v=50304, d_ff=None, moe=None):
    return ArchConfig(name=name, family="moe" if moe else "dense",
                      num_layers=L, d_model=d, num_heads=H,
                      num_kv_heads=H, d_ff=d_ff or 4 * d, vocab_size=v,
                      block_pattern=("attn_moe",) if moe else ("attn",),
                      moe=moe, source="arXiv:2005.14165 scaling table")


GPT_MEDIUM = _gpt("gpt-medium", 24, 1024, 16)
GPT_2_7B = _gpt("gpt-2.7b", 32, 2560, 32)
GPT_6_7B = _gpt("gpt-6.7b", 32, 4096, 32)
GPT_10B = _gpt("gpt-10b", 36, 4864, 38)
GPT_20B = _gpt("gpt-20b", 44, 6144, 48)
GPT_39B = _gpt("gpt-39.1b", 48, 8192, 64)
GPT_175B = _gpt("gpt-175b", 96, 12288, 96)
# GPT 5.12T MoE (paper's largest): 64 experts-ish trillion-scale config.
GPT_5T_MOE = _gpt("gpt-5.12t-moe", 64, 12288, 96,
                  d_ff=12288 * 4,
                  moe=MoECfg(num_experts=64, top_k=2, num_shared=0,
                             d_expert=4 * 12288))

FAMILY = {c.name: c for c in [GPT_MEDIUM, GPT_2_7B, GPT_6_7B, GPT_10B,
                              GPT_20B, GPT_39B, GPT_175B, GPT_5T_MOE]}


def tiny_gpt(layers=4, d=256, heads=4, vocab=512, d_ff=None) -> ArchConfig:
    """~100M-and-below GPTs for CPU end-to-end runs."""
    return _gpt(f"gpt-tiny-{layers}x{d}", layers, d, heads, v=vocab,
                d_ff=d_ff)
