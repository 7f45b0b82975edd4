"""--arch <id> registry (counterpart of `repro/models/registry.py`): maps
architecture ids to the port's own configs and reduced (smoke-test)
variants."""
from __future__ import annotations

import importlib
import math

from repro_torch.configs.base import SHAPES, ArchConfig, cell_supported
from repro_torch.models import backbone
from repro_torch.tree import tree_leaves

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "stablelm-1.6b": "stablelm_1_6b",
    "granite-3-8b": "granite_3_8b",
    "yi-34b": "yi_34b",
    "granite-8b": "granite_8b",
    "llava-next-34b": "llava_next_34b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        if arch_id.startswith("gpt"):
            from repro_torch.configs import gpt
            return gpt
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    m = _mod(arch_id)
    if hasattr(m, "CONFIG"):
        return m.CONFIG
    return m.FAMILY[arch_id]


def reduced_config(arch_id: str) -> ArchConfig:
    m = _mod(arch_id)
    if hasattr(m, "reduced"):
        return m.reduced()
    cfg = m.FAMILY[arch_id]
    return cfg.replace(num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=4, d_ff=128, vocab_size=256)


def all_cells():
    """Yield every live (arch, shape) dry-run cell + skipped ones."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            yield arch_id, shape.name, ok, why


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count from shapes only (the parameters are
    built on the meta device, so nothing is allocated). Raises
    NotImplementedError for a block type the port lacks."""
    params = backbone.init_params(cfg, None, tp=1, device="meta")
    return sum(math.prod(l.shape) for l in tree_leaves(params))
