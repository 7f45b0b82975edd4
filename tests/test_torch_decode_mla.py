"""DeepSeek-V2-Lite's serving path held against the JAX package: MLA's
latent cache and absorbed decode (`init_mla_cache`, `decode_mla`) with
and without a query latent, `decode_moe` with padded and shared
experts, and the `mla_moe` block's `decode_block` and `decode_step`.

As in tests/test_torch_mla.py, the reduced config runs with the full
model's MLA widths (kv_lora_rank 32, q.k 128 + 64, v 128)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import (close, decode_against_jax, jit,
                            one_torch_thread, to_port, trees_close, x)
from repro.configs import deepseek_v2_lite_16b as jds
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.configs.base import MLACfg as JMLACfg
from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs import deepseek_v2_lite_16b as ds
from repro_torch.configs import qwen2_moe_a2_7b as qwen
from repro_torch.configs.base import MLACfg
from repro_torch.models import blocks, mla, moe

# f32 throughout: sums of up to 192 products and 128 latent columns in
# other orders (the decode's own math is f32 whatever the weights are)
F32_TOL = 1e-5
B = 2
WIDE = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=128,
            qk_rope_dim=64, v_head_dim=128)


def _cfgs(q_lora_rank=0):
    w = dict(WIDE, q_lora_rank=q_lora_rank)
    return (ds.reduced().replace(mla=MLACfg(**w)),
            jds.reduced().replace(mla=JMLACfg(**w)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_cache_matches_jax(dtype):
    cfg, jcfg = _cfgs()
    want = jmla.init_mla_cache(jcfg, B, 7, jnp.dtype(dtype))
    got = mla.init_mla_cache(cfg, B, 7, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
        assert not got[k].any()


@pytest.mark.parametrize("q_lora_rank", [0, 16])
def test_decode_mla_matches_jax(q_lora_rank):
    """Eight tokens into a latent cache of six slots, f32: the mask is
    arange(T) <= pos before the update, and from pos 6 on the write
    lands on the last slot (dynamic_update_slice clamps its start)."""
    cfg, jcfg = _cfgs(q_lora_rank)
    jp = jmla.init_mla(jax.random.PRNGKey(q_lora_rank), jcfg, jnp.float32)
    jc = jmla.init_mla_cache(jcfg, B, 6, jnp.float32)
    p, cache = to_port(jp), to_port(jc)
    assert ("w_dq" in p) == bool(q_lora_rank)
    jdec = jit(lambda p, xx, c: jmla.decode_mla(p, xx, c, jcfg))
    for t in range(8):
        xt = x(10 + t, B, 1, cfg.d_model)
        want, jc = jdec(jp, jnp.asarray(xt), jc)
        got, cache = mla.decode_mla(p, torch.from_numpy(xt), cache, cfg)
        close(got, want, F32_TOL)
        trees_close(cache, jc, F32_TOL)
    assert int(cache["pos"]) == 8


@pytest.mark.parametrize("case", ["padded", "shared"])
def test_decode_moe_matches_jax(case):
    """decode_moe on three tokens of each of two rows: every expert runs,
    weighted by the renormalised top-k gates. "padded": DeepSeek's
    reduced MoE (8 experts, one shared) laid out for 3 expert-parallel
    shards, so 9 physical experts with the ninth masked out of routing;
    "shared": Qwen's reduced MoE with two shared experts."""
    if case == "padded":
        cfg, jcfg, ep = ds.reduced(), jds.reduced(), 3
    else:
        cfg, jcfg, ep = qwen.reduced(), jqwen.reduced(), 1
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg, ep, jnp.float32)
    p = to_port(jp)
    assert p["router"].shape[1] == (9 if case == "padded" else 8)
    xt = x(8, B, 3, cfg.d_model)
    want = jit(lambda p, xx: jmoe.decode_moe(p, xx, jcfg))(
        jp, jnp.asarray(xt))
    close(moe.decode_moe(p, torch.from_numpy(xt), cfg), want, F32_TOL)


def test_mla_moe_decode_block_matches_jax():
    """The block: RMSNorm -> decode_mla -> RMSNorm -> decode_moe, f32
    weights and cache, six tokens."""
    cfg, jcfg = _cfgs()
    jp = jblocks.init_block(jax.random.PRNGKey(2), "mla_moe", jcfg, 1,
                            jnp.float32)
    jc = jblocks.init_block_cache("mla_moe", jcfg, B, 8, 1, jnp.float32)
    p, cache = to_port(jp), to_port(jc)
    jdec = jit(lambda p, xx, c: jblocks.decode_block("mla_moe", p, xx, c,
                                                     jcfg, 1))
    for t in range(6):
        xt = x(30 + t, B, 1, cfg.d_model)
        want, jc = jdec(jp, jnp.asarray(xt), jc)
        got, cache = blocks.decode_block("mla_moe", p, torch.from_numpy(xt),
                                         cache, cfg, 1)
        close(got, want, F32_TOL)
        trees_close(cache, jc, F32_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(cache_dtype):
    """The reduced DeepSeek-V2-Lite (two mla_moe layers) token by token:
    logits and the whole cache tree after each of eight tokens. A bf16
    latent cache rounds both sides' f32 latents to 8 bits, and one near
    a bf16 midpoint can round either way (one step is 2^-8)."""
    cfg, jcfg = _cfgs()
    decode_against_jax(cfg, jcfg, 9, B, 8, 12, cache_dtype,
                       F32_TOL if cache_dtype == "float32" else 1e-2)
