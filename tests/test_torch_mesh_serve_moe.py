"""Serving the MoE block types under gloo meshes on the CPU, held against
the JAX package as tests/test_torch_mesh_serve.py holds `attn`:
reduced Qwen1.5-MoE (`attn_moe`) with 7 routed experts, padded to 8 at
tp 2 (the padded one on rank 1, masked through its global index), on
(1, 2): the router's logits gathered over `model`, the top-k over
every expert, each rank's experts on every token; reduced
DeepSeek-V2-Lite (`mla_moe`) at the full model's MLA widths (q.k 128 +
64, v 128, which the prefill's attention kernels take) on (1, 2), its
4 heads 2 a rank over the latent cache that every rank holds whole,
and on (2, 1), data parallel alone."""
import pytest

from decode_helpers import one_torch_thread
from test_torch_mesh_serve import (check_cache_blocks, check_decode,
                                   check_prefill, spawn_serve)

WIDTHS = {"kv_lora_rank": 32, "qk_nope_dim": 128, "qk_rope_dim": 64,
          "v_head_dim": 128}
CASES = {"qwen7": dict(arch="qwen2-moe-a2.7b", tp=2, steps=4, max_len=6,
                       cuts={"moe": {"num_experts": 7}}),
         "ds": dict(arch="deepseek-v2-lite-16b", tp=2, steps=4, max_len=6,
                    cuts={"mla": WIDTHS}),
         "ds1": dict(arch="deepseek-v2-lite-16b", tp=1, steps=4, max_len=6,
                     cuts={"mla": WIDTHS})}
RUNS = [("qwen7", "1x2", 2), ("ds", "1x2", 2), ("ds1", "2x1", 2)]
IDS = [f"{n}-{m}" for n, m, _ in RUNS]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn_serve(tmp_path_factory.mktemp("mesh_serve_moe"), CASES,
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
