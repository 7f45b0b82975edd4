"""Reduced DeepSeek-V2-Lite (multi-head latent attention over 8 routed
experts, at the full model's MLA widths q.k 128 + 64 and v 128, which
the attention kernels take, and kv_lora_rank 32) on gloo meshes on the
CPU: on (1, 2) MLA's 4 heads and the experts split 2 and 4 a rank, on
(2, 1) data parallel alone (its tp-1 layout is tp 2's), where the
load-balance loss spans the data ranks; held against the JAX package
with no mesh as tests/test_torch_mesh.py holds Yi: the forward's
logits, one train step (the loss with the aux loss), and each rank's
blocks."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh import check_blocks, check_parity, spawn_parity

WIDTHS = {"kv_lora_rank": 32, "qk_nope_dim": 128, "qk_rope_dim": 64,
          "v_head_dim": 128}
CASES = {"ds": ("deepseek-v2-lite-16b", 16, {"mla": WIDTHS})}
RUNS = [("ds", "1x2", 2), ("ds", "2x1", 2)]
IDS = [f"{n}-{m}" for n, m, _ in RUNS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh_mla"), CASES, RUNS)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_forward_and_train_step_match_jax(ranks, name, mesh, world):
    check_parity(ranks, name, mesh, world)


@pytest.mark.parametrize("name,mesh,world", RUNS, ids=IDS)
def test_each_rank_holds_only_its_blocks(ranks, name, mesh, world):
    check_blocks(ranks, name, mesh, world)
