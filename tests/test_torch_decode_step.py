"""`decode_step` token by token against the JAX package's, logits and
the whole cache tree after each token, for the attention block types
and RecurrentGemma's hybrid stack (xLSTM's and DeepSeek-V2-Lite's are
in tests/test_torch_decode_xlstm.py and tests/test_torch_decode_mla.py)."""
import pytest

from decode_helpers import decode_against_jax, one_torch_thread
from repro.models import registry as jregistry
from repro_torch.models import registry

# f32: the same products summed in other orders over up to 64 terms and
# a few layers. A bf16 cache holds both sides' f32 keys and values
# rounded to 8 bits, and a value within an f32 rounding of a bf16
# midpoint can round either way (one bf16 step is 2^-8 of the value)
F32_TOL, BF16_CACHE_TOL = 1e-5, 1e-2
B = 2


@pytest.mark.parametrize("arch,cache_dtype", [
    ("stablelm-1.6b", "float32"), ("stablelm-1.6b", "bfloat16"),
    ("yi-34b", "float32"), ("yi-34b", "bfloat16"),
    ("qwen2-moe-a2.7b", "float32"), ("recurrentgemma-2b", "float32")])
def test_decode_step_matches_jax(arch, cache_dtype):
    """Token by token from empty caches, the reference's f32 weights:
    logits and the whole cache tree after each token. Yi's reduced
    config has 7 q heads on one kv head (G = 7); RecurrentGemma's at 5
    layers (one period of rglru, rglru, local_attn, and two rglru in the
    tail) decodes 20 tokens past its window of 16; Qwen's MoE decodes
    with shared experts."""
    rg = arch == "recurrentgemma-2b"
    kw = {"num_layers": 5} if rg else {}
    cfg = registry.reduced_config(arch).replace(**kw)
    jcfg = jregistry.reduced_config(arch).replace(**kw)
    steps = 20 if rg else 10
    tol = F32_TOL if cache_dtype == "float32" else BF16_CACHE_TOL
    decode_against_jax(cfg, jcfg, 5, B, steps, 24, cache_dtype, tol)
