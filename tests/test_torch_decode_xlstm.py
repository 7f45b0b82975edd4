"""xLSTM's serving path held against the JAX package: the plain
chunkwise mLSTM from a carried state, the conv with a carried context,
both cells with a decode state, the init states (RG-LRU's too) and
`decode_step` token by token; and the training path, with no state,
still on the kernels' wrapper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_helpers import (close, decode_against_jax, jit,
                            one_torch_thread, to_port, trees_close, x)
from repro.configs import recurrentgemma_2b as jrg
from repro.configs import xlstm_350m as jxc
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.configs import recurrentgemma_2b as rgc
from repro_torch.configs import xlstm_350m as xc
from repro_torch.models import rglru, xlstm

# f32: the chunk's sums over K = 64 and up to 11 steps, exponentials of
# the same gates, in other orders
F32_TOL = 1e-5
B = 2


def _state(seed, b, h, k):
    """A carried (C, n, m) that is not the zero state: C and n of the
    size a few steps leave, m a log-scale stabiliser."""
    return (x(seed, b, h, k, k, scale=0.3), x(seed + 1, b, h, k),
            x(seed + 2, b, h, scale=2.0))


@pytest.mark.parametrize("s,chunk", [(1, 1), (11, 8)])
def test_mlstm_chunkwise_from_a_state_matches_jax(s, chunk):
    """S = 1 at chunk 1 (decode's min(chunk, S)) and S = chunk + 3 (one
    chunk and a padded second), from a non-zero state: h and the state
    after step S."""
    h, k = 2, 16
    ins = [x(1, B, h, s, k), x(2, B, h, s, k), x(3, B, h, s, k),
           x(4, B, h, s), np.log(1 / (1 + np.exp(-x(5, B, h, s) - 3)))]
    st = _state(6, B, h, k)
    want_h, want_st = jit(
        lambda *a: jxlstm.mlstm_chunkwise(*a[:5], a[5:], chunk=chunk))(
            *(jnp.asarray(a) for a in ins + list(st)))
    got_h, got_st = xlstm.mlstm_chunkwise(
        *(torch.from_numpy(a.astype(np.float32)) for a in ins),
        tuple(torch.from_numpy(a) for a in st), chunk=chunk)
    close(got_h, want_h, F32_TOL)
    for g, w in zip(got_st, want_st):
        close(g, w, F32_TOL)


def test_conv_silu_with_context_matches_jax():
    """The causal conv + SiLU over three steps after a carried context of
    W - 1 = 3 inputs; returns the last 3 inputs as the next context."""
    xx, ctx = x(7, B, 3, 16), x(8, B, 3, 16)
    w, b = x(9, 4, 16, scale=0.3), x(10, 16, scale=0.1)
    want, want_ctx = jxlstm._conv_silu(*map(jnp.asarray, (xx, w, b, ctx)))
    got, got_ctx = xlstm._conv_silu(*map(torch.from_numpy, (xx, w, b, ctx)))
    close(got, want, F32_TOL)
    close(got_ctx, want_ctx, 0.0)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_with_a_state_matches_jax(cell):
    """Each cell decodes three tokens one at a time from its init state,
    f32 weights: the output and the whole state after each token."""
    jcfg, cfg = jxc.reduced(), xc.reduced()
    jinit, japply, jstate = {
        "mlstm": (jxlstm.init_mlstm, jxlstm.apply_mlstm,
                  jxlstm.init_mlstm_state),
        "slstm": (jxlstm.init_slstm, jxlstm.apply_slstm,
                  jxlstm.init_slstm_state)}[cell]
    apply = {"mlstm": xlstm.apply_mlstm, "slstm": xlstm.apply_slstm}[cell]
    jp = jinit(jax.random.PRNGKey(4), jcfg, jnp.float32)
    js = jstate(jcfg, B)
    p, st = to_port(jp), to_port(js)
    jdec = jit(lambda p, xx, s: japply(p, xx, jcfg, state=s))
    for t in range(3):
        xt = x(20 + t, B, 1, cfg.d_model)
        want, js = jdec(jp, jnp.asarray(xt), js)
        got, st = apply(p, torch.from_numpy(xt), cfg, state=st)
        close(got, want, F32_TOL)
        trees_close(st, js, F32_TOL)


def test_init_states_match_jax():
    """init_mlstm_state, init_slstm_state and init_rglru_state: the
    reference's keys, shapes, dtypes (f32) and values (m at -1e30)."""
    pairs = [(xlstm.init_mlstm_state(xc.CONFIG, 3),
              jxlstm.init_mlstm_state(jxc.CONFIG, 3)),
             (xlstm.init_slstm_state(xc.CONFIG, 3),
              jxlstm.init_slstm_state(jxc.CONFIG, 3)),
             (rglru.init_rglru_state(rgc.reduced(), 3),
              jrglru.init_rglru_state(jrg.reduced(), 3))]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == torch.float32 and want[k].dtype == \
                jnp.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_training_path_without_a_state_runs_the_kernel(monkeypatch):
    """With state None the mLSTM cell still goes through
    ops.mlstm_chunkwise (the CUDA kernels on the card) and returns no
    state; a decode state takes the plain carried path instead."""
    calls = []
    real = xlstm.ops.mlstm_chunkwise
    monkeypatch.setattr(xlstm.ops, "mlstm_chunkwise",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = xc.reduced()
    p = xlstm.init_mlstm(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    y, st = xlstm.apply_mlstm(p, torch.from_numpy(x(1, B, 5, 64)), cfg)
    assert st is None and y.shape == (B, 5, 64) and calls == [1]
    _, st = xlstm.apply_mlstm(p, torch.from_numpy(x(2, B, 1, 64)), cfg,
                              state=xlstm.init_mlstm_state(cfg, B))
    assert sorted(st) == ["C", "conv", "m", "n"] and calls == [1]


def test_decode_step_matches_jax():
    """The reduced xLSTM at 5 layers (two (mlstm, slstm) periods and an
    mlstm tail) token by token, f32 weights: logits and the whole state
    tree after each of six tokens."""
    cfg, jcfg = (c.reduced().replace(num_layers=5) for c in (xc, jxc))
    decode_against_jax(cfg, jcfg, 11, B, 6, 8, "float32", F32_TOL)
