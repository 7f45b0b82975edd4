"""Serving Whisper (`attn_cross`) under a (1, 2) gloo mesh on the CPU,
held against the JAX package as tests/test_torch_mesh_serve.py holds
`attn`: reduced Whisper (2 enc_attn encoder layers over 32 frames, 2
attn_cross decoder layers, 4 heads): setup_cross_cache runs the encoder
on each rank's rows of the frames and its heads and writes each
layer's cross K/V on its kv slots, then the split decode."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh_serve import (F32_TOL, check_cache_blocks,
                                   check_decode, check_prefill,
                                   leaves_close, spawn_serve)

CASES = {"wh": dict(arch="whisper-medium", tp=2, steps=4, max_len=6)}
RUNS = [("wh", "1x2", 2)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn_serve(tmp_path_factory.mktemp("mesh_serve_wh"), CASES,
                       RUNS)


def test_setup_cross_cache_matches_jax(served):
    """The whole cache tree after setup_cross_cache: the cross K/V of
    every layer gathered over the ranks' rows and kv slots."""
    got, want, _ = served
    for r in range(2):
        leaves_close(got[2, r]["wh 1x2"]["cross"], want["wh"]["cross"],
                     F32_TOL)


def test_decode_matches_jax(served):
    check_decode(served, *RUNS[0])


def test_prefill_matches_jax(served):
    check_prefill(served, *RUNS[0])


def test_each_rank_holds_only_its_cache_block(served):
    check_cache_blocks(served, *RUNS[0])
