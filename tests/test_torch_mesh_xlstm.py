"""Reduced xLSTM (one mlstm, slstm period; 2 heads of 64 over 128 inner
lanes) on a (1, 2) gloo mesh on the CPU: each rank holds 64 of the
mLSTM's lanes (its block of w_up's [x_m | z] columns is all of one
branch, so the up projection is gathered and each rank takes its lanes
of both halves) and runs its head of the cell; the sLSTM's recurrence
runs whole and its GeGLU feed-forward split. Seq 80: two chunks of 64,
the second padded. On (1, 4), whose `model` extent does not divide the 2
heads, each rank holds 32 lanes and runs the cell on both heads, then
keeps its lanes. Held against the JAX package with no mesh as
tests/test_torch_mesh.py holds Yi: the forward's logits, one train
step, and each rank's blocks."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh import check_blocks, check_parity, spawn_parity

CASES = {"xl": ("xlstm-350m", 80)}
RUNS = [("xl", "1x2", 2), ("xl", "1x4", 4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh_xl"), CASES, RUNS)


def test_forward_and_train_step_match_jax(ranks):
    check_parity(ranks, *RUNS[0])


def test_each_rank_holds_only_its_blocks(ranks):
    check_blocks(ranks, *RUNS[0])


def test_all_heads_on_every_rank_match_jax(ranks):
    """1x4: the cell runs both heads on each rank, which keeps its 32
    lanes of the output; the gradients of the summed products are added
    over `model`."""
    check_parity(ranks, *RUNS[1])
    check_blocks(ranks, *RUNS[1])
