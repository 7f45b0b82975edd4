"""The port's serving path held against the JAX package: the KV cache
primitives (full and ring), `decode_attn` and `decode_block` for the
attention block types, `make_serve_step`, the cache tree; and decode
against the port's own forward at the reference's tolerance
(tests/test_archs_smoke.py). `decode_step` token by token is in
tests/test_torch_decode_step.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import (close, jit, one_torch_thread, to_port, tokens,
                            trees_close, x)
from repro.models import attention as jatt
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as att
from repro_torch.models import backbone, blocks, registry
from repro_torch.train import step
from repro_torch.tree import tree_leaves

# f32: the same products summed in other orders over up to 64 terms
F32_TOL = 1e-5
# decode against the forward at bf16 weights and caches: the reference's
# own bound (tests/test_archs_smoke.py:86-87)
REF_RTOL = REF_ATOL = 0.05
B = 2


def _cfgs(arch, **kw):
    return (registry.reduced_config(arch).replace(**kw),
            jregistry.reduced_config(arch).replace(**kw))


# ------------------------------------------------------ cache primitives
@pytest.mark.parametrize("ring", [False, True])
def test_cache_primitives_match_jax(ring):
    """init_kv_cache, cache_update, cache_positions and decode_attend step
    by step past the cache's end: a full cache of 5 slots (the last slot
    rewritten from pos 5 on) and a ring of window 4 in max_len 10
    (wrapped twice, the window masking slots that still hold older
    positions); G = 3 q heads per kv head, f32."""
    max_len, window, n, g, k = (10, 4, 2, 3, 8) if ring else (5, 0, 2, 3, 8)
    jc = jatt.init_kv_cache(B, max_len, n, k, jnp.float32, ring=ring,
                            window=window)
    cache = att.init_kv_cache(B, max_len, n, k, torch.float32, ring=ring,
                              window=window)
    trees_close(cache, jc, 0.0)
    assert cache["k"].shape[1] == (4 if ring else 5)
    for t in range(9):
        kn, vn, q = x(t, B, 1, n, k), x(50 + t, B, 1, n, k), \
            x(100 + t, B, 1, n, g, k)
        qpos = np.full((B, 1), t, np.int32)
        jc = jatt.cache_update(jc, jnp.asarray(kn), jnp.asarray(vn),
                               ring=ring)
        cache = att.cache_update(cache, torch.from_numpy(kn),
                                 torch.from_numpy(vn), ring=ring)
        trees_close(cache, jc, 0.0)
        np.testing.assert_array_equal(
            att.cache_positions(cache, ring=ring).numpy(),
            np.asarray(jatt.cache_positions(jc, ring=ring)))
        want = jatt.decode_attend(jnp.asarray(q), jc, jnp.asarray(qpos),
                                  ring=ring, window=window)
        got = att.decode_attend(torch.from_numpy(q), cache,
                                torch.from_numpy(qpos), ring=ring,
                                window=window)
        close(got, want, F32_TOL)


def test_unwritten_slots_add_nothing():
    """A cache whose unwritten slots hold NaN decodes bit for bit as one
    that holds zeros: decode_attend zeroes what it masks."""
    caches = [att.init_kv_cache(B, 6, 1, 8, torch.float32) for _ in "ab"]
    caches[1]["k"].fill_(float("nan"))
    caches[1]["v"].fill_(float("nan"))
    for t in range(3):
        kn, vn = torch.from_numpy(x(t, B, 1, 1, 8)), \
            torch.from_numpy(x(9 + t, B, 1, 1, 8))
        q = torch.from_numpy(x(20 + t, B, 1, 1, 2, 8))
        outs = []
        for i, c in enumerate(caches):
            caches[i] = c = att.cache_update(c, kn, vn)
            outs.append(att.decode_attend(q, c, torch.full((B, 1), t)))
        assert torch.isfinite(outs[1]).all() and torch.equal(*outs)


# ------------------------------------------------------------- blocks
BLOCKS = {"attn": "stablelm-1.6b", "attn_moe": "qwen2-moe-a2.7b",
          "local_attn": "recurrentgemma-2b"}


@pytest.mark.parametrize("btype", sorted(BLOCKS))
def test_decode_block_matches_jax(btype):
    """decode_block (decode_attn, then the MLP or decode_moe) for 20
    tokens against the reference's, f32 weights and cache: for
    local_attn the ring of window 16 wraps after token 16."""
    cfg, jcfg = _cfgs(BLOCKS[btype])
    jp = jblocks.init_block(jax.random.PRNGKey(3), btype, jcfg, 1,
                            jnp.float32)
    jc = jblocks.init_block_cache(btype, jcfg, B, 24, 1, jnp.float32)
    p, cache = to_port(jp), to_port(jc)
    jdec = jit(lambda p, xx, c: jblocks.decode_block(btype, p, xx, c, jcfg,
                                                     1))
    for t in range(20):
        xt = x(200 + t, B, 1, cfg.d_model)
        want, jc = jdec(jp, jnp.asarray(xt), jc)
        got, cache = blocks.decode_block(btype, p, torch.from_numpy(xt),
                                         cache, cfg, 1)
        close(got, want, F32_TOL)
        trees_close(cache, jc, F32_TOL)
    if btype == "local_attn":
        assert cache["k"].shape[1] == 16 and int(cache["pos"]) == 20


@pytest.mark.parametrize("call", ["init_block_cache", "decode_block"])
def test_attn_cross_still_raises(call):
    """Whisper's blocks at the two calls that raised until its encoder
    was ported. `attn_cross` now matches the reference: init_block_cache
    gives its tree ({"self": a KV cache, "cross_k", "cross_v" of
    encoder_seq slots}, zeros), and decode_block decodes 6 tokens, f32,
    over cross K/V set from seeded values (the cross query at the
    position the self cache just took, the keys without RoPE). The
    encoder's `enc_attn` has no cache and still raises ValueError at
    both calls, as the reference's does."""
    cfg, jcfg = _cfgs("whisper-medium")
    jc = jblocks.init_block_cache("attn_cross", jcfg, B, 8, 1, jnp.float32)
    cache = blocks.init_block_cache("attn_cross", cfg, B, 8, 1,
                                    torch.float32)
    if call == "init_block_cache":
        assert sorted(cache) == ["cross_k", "cross_v", "self"]
        assert tuple(cache["cross_k"].shape) == (B, cfg.encoder_seq, 4, 16)
        trees_close(cache, jc, 0.0)
        ref = lambda: jblocks.init_block_cache("enc_attn", jcfg, B, 8, 1)
        mine = lambda: blocks.init_block_cache("enc_attn", cfg, B, 8, 1)
    else:
        jp = jblocks.init_block(jax.random.PRNGKey(8), "attn_cross", jcfg, 1,
                                jnp.float32)
        shape = (B, cfg.encoder_seq, 4, 16)
        jc = dict(jc, cross_k=jnp.asarray(x(30, *shape)),
                  cross_v=jnp.asarray(x(31, *shape)))
        p, cache = to_port(jp), to_port(jc)
        jdec = jit(lambda p, xx, c: jblocks.decode_block(
            "attn_cross", p, xx, c, jcfg, 1))
        for t in range(6):
            xt = x(300 + t, B, 1, cfg.d_model)
            want, jc = jdec(jp, jnp.asarray(xt), jc)
            got, cache = blocks.decode_block("attn_cross", p,
                                             torch.from_numpy(xt), cache,
                                             cfg, 1)
            close(got, want, F32_TOL)
            trees_close(cache, jc, F32_TOL)
        xt = torch.zeros(B, 1, cfg.d_model)
        ref = lambda: jblocks.decode_block("enc_attn", jp, jnp.asarray(xt),
                                           jc, jcfg, 1)
        mine = lambda: blocks.decode_block("enc_attn", p, xt, cache, cfg, 1)
    for fn in (ref, mine):
        with pytest.raises(ValueError):
            fn()


# ---------------------------------------------------------- serve step
def test_make_serve_step_matches_decode_step():
    """make_serve_step on the CPU is decode_step without gradients: the
    same logits and caches bit for bit, from numpy tokens, and no graph
    even when the weights require gradients; in the tp-1 layout, and
    with `tp` 2 in tp 2's (7 q heads padded to 8 on 2 kv slots, the
    vocab padded to 256)."""
    cfg = registry.reduced_config("yi-34b")
    for tp in (1, 2):
        gen = torch.Generator().manual_seed(0)
        params = backbone.init_params(cfg, gen, tp=tp, dtype=torch.float32)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        serve = step.make_serve_step(cfg, device="cpu", tp=tp)
        caches = [backbone.init_cache(cfg, B, 6, tp=tp, dtype=torch.float32,
                                      device="cpu") for _ in "ab"]
        assert caches[0]["scan"][0]["k"].shape[3] == tp
        for t in range(4):
            tok = tokens(t, B, 1)
            got, caches[0] = serve(params, caches[0], tok)
            with torch.no_grad():
                want, caches[1] = backbone.decode_step(
                    params, caches[1], torch.from_numpy(tok).long(), cfg,
                    tp)
            assert not got.requires_grad and torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(caches[0]), tree_leaves(caches[1])))
        assert int(caches[0]["scan"][0]["pos"][0]) == 4


def test_cache_tree_and_convert_match_jax():
    """init_cache's tree is the reference's leaf for leaf (shapes, dtypes,
    the stacked int32 pos) for every decoder pattern the port serves,
    and convert carries a cache both ways with the same bytes."""
    for arch in ("stablelm-1.6b", "recurrentgemma-2b", "xlstm-350m",
                 "deepseek-v2-lite-16b"):
        cfg, jcfg = _cfgs(arch, num_layers=5)
        for dt in ("float32", "bfloat16"):
            jc = jax.eval_shape(lambda: jbackbone.init_cache(
                jcfg, B, 12, tp=1, dtype=jnp.dtype(dt)))
            mine = backbone.init_cache(cfg, B, 12, dtype=getattr(torch, dt),
                                       device="cpu")
            got, want = tree_leaves(mine), jax.tree.leaves(jc)
            assert [(tuple(a.shape), str(a.dtype)[6:]) for a in got] == \
                [(b.shape, str(b.dtype)) for b in want]
    jc = jbackbone.init_cache(_cfgs("recurrentgemma-2b")[1], B, 12)
    jc = jax.tree.map(lambda a: a + 1, jc)
    back = params_to_numpy(params_from_numpy(
        jax.tree.map(np.asarray, jc), "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------ decode against forward
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_decode_matches_forward(arch):
    """The reference's test on the port alone: bf16 weights and a bf16
    cache, B 2, decode token by token against the full forward at rtol =
    atol = 0.05. RecurrentGemma, at 5 layers (a period and a two-layer
    tail), decodes 24 tokens, past its window 16."""
    rg = arch == "recurrentgemma-2b"
    cfg = registry.reduced_config(arch).replace(
        **({"num_layers": 5} if rg else {}))
    S = 24 if rg else 16
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(tokens(1, B, S, cfg.vocab_size)).long()
    full, _ = backbone.forward(params, tok, cfg, remat=False)
    cache = backbone.init_cache(cfg, B, S, device="cpu")
    serve = step.make_serve_step(cfg, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = serve(params, cache, tok[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=REF_RTOL, atol=REF_ATOL)
