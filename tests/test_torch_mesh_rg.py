"""Reduced RecurrentGemma on a (1, 2) gloo mesh on the CPU (its RG-LRU
lanes, heads (2 q on one kv, one each of 2 kv slots at tp 2) and vocab
split; window 16 below seq 32), held against the JAX package at tp 2
with no mesh as tests/test_torch_mesh.py holds Yi: the forward's
logits, one train step, and each rank's blocks."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh import check_blocks, check_parity, spawn_parity

CASES = {"rg": ("recurrentgemma-2b", 32)}
RUNS = [("rg", "1x2", 2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh_rg"), CASES, RUNS)


def test_forward_and_train_step_match_jax(ranks):
    check_parity(ranks, *RUNS[0])


def test_each_rank_holds_only_its_blocks(ranks):
    check_blocks(ranks, *RUNS[0])

