"""Serving the recurrent block types under a (1, 2) gloo mesh on the CPU,
held against the JAX package as tests/test_torch_mesh_serve.py holds
`attn`: reduced RecurrentGemma (one period of rglru, rglru,
local_attn) decoding 20 tokens past its window of 16 (the ring of 16
slots wraps), each rank on its 32 of the RG-LRU's 64 lanes and its kv
slot (2 q heads on one kv head, 2 kv slots at tp 2); reduced xLSTM (one
mlstm, slstm period; 2 heads), each rank carrying its head of the
mLSTM's state (the port's layout, ROADMAP Queue 3; the test compares
the gathered whole) and the sLSTM's state whole."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh_serve import (check_cache_blocks, check_decode,
                                   check_prefill, spawn_serve)

CASES = {"rg": dict(arch="recurrentgemma-2b", tp=2, steps=20, max_len=24),
         "xl": dict(arch="xlstm-350m", tp=2, steps=5, max_len=8)}
RUNS = [("rg", "1x2", 2), ("xl", "1x2", 2)]
IDS = [f"{n}-{m}" for n, m, _ in RUNS]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn_serve(tmp_path_factory.mktemp("mesh_serve_rec"), CASES,
                       RUNS)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_decode_matches_jax(served, name, mesh, world):
    check_decode(served, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_prefill_matches_jax(served, name, mesh, world):
    check_prefill(served, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_each_rank_holds_only_its_cache_block(served, name, mesh, world):
    check_cache_blocks(served, name, mesh, world)
