"""The plain chunked (online softmax) and sliding-window attention
(`models/attention.py` `chunked_attention`, `local_attention`) against
the JAX package's at f32 1e-5: causal and not, with a window, ragged S
(the last q and kv chunks short), q and kv of other lengths, padded key
positions; and the kernels' plain versions, which take the chunked form
above `CHUNKED_FROM` queries, against their whole form there (forward:
o and lse; backward: dq, dk, dv), without the (BH, S, S) logits."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import op_analyzer
from repro_torch.models import attention as att

TOL = 1e-5


def _inputs(seed, B, S, T, N, G, K, V=None, pad_keys=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, G, K)).astype(np.float32)
    k = rng.standard_normal((B, T, N, K)).astype(np.float32)
    v = rng.standard_normal((B, T, N, V or K)).astype(np.float32)
    qp = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    kp = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32).copy()
    if pad_keys:
        kp[:, -pad_keys:] = jatt.PAD_SENTINEL + 7
    return q, k, v, qp, kp


def _torch(*xs):
    q, k, v, qp, kp = xs
    return (*(torch.tensor(x) for x in (q, k, v)), torch.tensor(qp).long(),
            torch.tensor(kp).long())


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


CHUNKED = [  # B, S, T, N, G, K, V, causal, window, q_chunk, kv_chunk, pad
    (2, 37, 37, 2, 2, 8, 8, True, 0, 8, 16, 0),
    (2, 37, 37, 2, 2, 8, 8, False, 0, 8, 16, 0),
    (2, 40, 40, 1, 3, 8, 8, True, 9, 8, 16, 0),
    (1, 13, 29, 2, 1, 16, 8, False, 0, 4, 8, 5),
    (2, 64, 64, 2, 2, 8, 8, True, 0, 512, 1024, 0),   # one chunk each
    (1, 50, 50, 1, 2, 8, 8, True, 7, 16, 16, 3),
]


@pytest.mark.parametrize("case", CHUNKED)
def test_chunked_attention_matches_jax(case):
    B, S, T, N, G, K, V, causal, window, qc, kc, pad = case
    xs = _inputs(sum(case[:7]), B, S, T, N, G, K, V, pad)
    want = jatt.chunked_attention(*xs, causal=causal, window=window,
                                  q_chunk=qc, kv_chunk=kc)
    got = att.chunked_attention(*_torch(*xs), causal=causal, window=window,
                                q_chunk=qc, kv_chunk=kc)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


LOCAL = [  # B, S, N, G, K, window, q_chunk
    (2, 64, 1, 3, 8, 9, 8),      # sliced spans of window + chunk keys
    (2, 64, 2, 2, 8, 4, 16),
    (2, 37, 1, 3, 8, 9, 8),      # ragged S: the chunked form
    (2, 40, 1, 2, 8, 30, 16),    # the span covers T: the chunked form
]


@pytest.mark.parametrize("case", LOCAL)
def test_local_attention_matches_jax(case):
    B, S, N, G, K, window, qc = case
    xs = _inputs(sum(case), B, S, S, N, G, K)
    want = jatt.local_attention(*xs, window=window, q_chunk=qc)
    got = att.local_attention(*_torch(*xs), window=window, q_chunk=qc)
    _close(got, want)


def test_bf16_inputs_give_bf16():
    xs = _inputs(3, 1, 24, 24, 1, 2, 8)
    want = jatt.chunked_attention(*[np.asarray(x, jatt.jnp.bfloat16)
                                    if x.dtype == np.float32 else x
                                    for x in xs], q_chunk=8, kv_chunk=8)
    q, k, v, qp, kp = _torch(*xs)
    got = att.chunked_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), qp,
                                kp, q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


@settings(max_examples=12, deadline=None)
@given(S=st.integers(1, 40), window=st.integers(0, 12),
       qc=st.sampled_from([4, 7, 16]), kc=st.sampled_from([5, 8, 64]),
       causal=st.booleans())
def test_chunked_attention_is_dense_attention(S, window, qc, kc, causal):
    """Any S, window and chunking: the chunked form is the dense one."""
    xs = _torch(*_inputs(S, 1, S, S, 1, 2, 8))
    want = att.dense_attention(*xs, causal=causal, window=window)
    got = att.chunked_attention(*xs, causal=causal, window=window,
                                q_chunk=qc, kv_chunk=kc)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------------ the kernels' plain form
PLAIN = [  # BH, S, dk, dv, causal, window
    (1, fa.CHUNKED_FROM + 52, 16, 16, True, 0),
    (2, fa.CHUNKED_FROM + 1, 32, 32, True, 700),
    (1, fa.CHUNKED_FROM + 300, 16, 16, False, 0),
    (1, fa.CHUNKED_FROM + 1, 192, 128, True, 0),
]


@pytest.mark.parametrize("case", PLAIN)
def test_plain_versions_past_the_length_are_the_whole_form(case,
                                                           monkeypatch):
    bh, s, dk, dv, causal, window = case
    gen = torch.Generator().manual_seed(s)
    q, k = (torch.randn(bh, s, dk, generator=gen) for _ in range(2))
    v, do = (torch.randn(bh, s, dv, generator=gen) for _ in range(2))
    sc = dk ** -0.5
    calls = []
    chunked = fa.attention_fwd_chunked
    monkeypatch.setattr(fa, "attention_fwd_chunked",
                        lambda *a: calls.append(1) or chunked(*a))
    o, lse = fa.attention_fwd_ref(q, k, v, causal, sc, window)
    grads = fa.attention_bwd_ref(q, k, v, o, lse, do, causal, sc, window)
    assert calls == [1]
    monkeypatch.setattr(fa, "CHUNKED_FROM", s)          # the whole form
    o2, lse2 = fa.attention_fwd_ref(q, k, v, causal, sc, window)
    grads2 = fa.attention_bwd_ref(q, k, v, o2, lse2, do, causal, sc, window)
    assert calls == [1]
    for got, want in zip((o, lse, *grads), (o2, lse2, *grads2)):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_plain_versions_below_the_length_are_unchanged():
    """At CHUNKED_FROM queries the plain forward is the whole form, bit
    for bit."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 16, generator=gen) for _ in range(3))
    s = torch.einsum("bsk,btk->bst", q, k) * 0.25
    s = torch.where(torch.ones(64, 64, dtype=torch.bool).tril(), s,
                    torch.full_like(s, fa.NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    den = torch.clamp(p.sum(-1), min=1e-30)
    o, lse = fa.attention_fwd_ref(q, k, v, True, 0.25)
    assert torch.equal(o, torch.einsum("bst,btk->bsk", p, v)
                       / den[..., None])
    assert torch.equal(lse, m + torch.log(den))


@pytest.mark.parametrize("window", [0, 1024])
def test_long_plain_attention_never_holds_the_logits(window):
    """At S 8192 (BH 1, d 64) the plain forward and backward, run on
    `meta` under the dry-run's tracker, never hold a (BH, S, S) f32
    block (256 MiB): a chunk's blocks are (BH, Q_CHUNK, keys), and the
    peak stays under half of it."""
    s, d = 8192, 64
    m = lambda *shape: torch.empty(*shape, device="meta")
    q, k, v, do = m(1, s, d), m(1, s, d), m(1, s, d), m(1, s, d)
    with op_analyzer.analyze([q, k, v, do]) as an:
        o, lse = fa.attention_fwd_ref(q, k, v, True, d ** -0.5, window)
        fa.attention_bwd_ref(q, k, v, o, lse, do, True, d ** -0.5, window)
    assert an.peak_bytes - an.argument_bytes < s * s * 4 // 2
