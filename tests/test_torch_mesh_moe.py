"""Reduced Qwen1.5-MoE on gloo meshes on the CPU, expert parallel: its 8
experts 4 a rank at tp 2 (routing over the whole gathered logits, each
rank's rows routed alone, as capacity is per batch row), its shared
experts and heads split, held against the JAX package at tp 2 with no
mesh as tests/test_torch_mesh.py holds Yi: on (2, 2), where the
load-balance loss spans the data ranks, on (1, 2), and a variant with 7
routed experts (padded to 8 at tp 2, the padded one on rank 1 and
masked through its global index) on (1, 2). The forward's logits, one
train step (the loss with the aux loss), and each rank's blocks."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh import check_blocks, check_parity, spawn_parity

CASES = {"qwen": ("qwen2-moe-a2.7b", 16),
         "qwen7": ("qwen2-moe-a2.7b", 16, {"moe": {"num_experts": 7}})}
RUNS = [("qwen", "2x2", 4), ("qwen", "1x2", 2), ("qwen7", "1x2", 2)]
IDS = [f"{n}-{m}" for n, m, _ in RUNS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh_moe"), CASES, RUNS)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_forward_and_train_step_match_jax(ranks, name, mesh, world):
    check_parity(ranks, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_each_rank_holds_only_its_blocks(ranks, name, mesh, world):
    check_blocks(ranks, name, mesh, world)
