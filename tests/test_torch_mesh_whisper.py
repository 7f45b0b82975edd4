"""Reduced Whisper (2 enc_attn encoder layers over 32 frames, 2
attn_cross decoder layers, 4 heads) on a (1, 2) gloo mesh on the CPU:
the encoder on each rank's rows of the frames and its 2 heads, each
decoder layer's cross K/V projected to the rank's kv slots from the
encoder's output (its gradient summed over `model` once), the
cross-attention on the rank's heads. Held against the JAX package at
tp 2 with no mesh as tests/test_torch_mesh.py holds Yi: the forward's
logits, one train step, and each rank's blocks."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh import check_blocks, check_parity, spawn_parity

CASES = {"wh": ("whisper-medium", 16)}
RUNS = [("wh", "1x2", 2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_parity(tmp_path_factory.mktemp("mesh_wh"), CASES, RUNS)


def test_forward_and_train_step_match_jax(ranks):
    check_parity(ranks, *RUNS[0])


def test_each_rank_holds_only_its_blocks(ranks):
    check_blocks(ranks, *RUNS[0])
