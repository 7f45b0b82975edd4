"""The launcher under meshes on real gloo process groups on the CPU: a
run at --mesh 2x1 checkpointed and resumed at --mesh 1x2 (another
shape, the same tp-1 layout: reduced StableLM's heads and vocab divide)
against an unbroken run with no mesh; FSDP at 2x1 against ZeRO-1;
the loss over split rows (masks of unequal counts) and a split
vocabulary; what a mesh refuses (prefill, serving and decoding, MLA at
a tp that does not divide its heads, a batch the data ranks do not
divide among it) and that every block type's train step builds under
one; that a mesh of one shape is made once per process group; and
--mesh on the card without CUDA. The two ranks run
`mesh_workers.launcher` with f32 parameters, spawned once for the
module.
"""
import numpy as np
import pytest
import torch

import mesh_workers
from decode_helpers import close, one_torch_thread
from repro_torch.launch import train as launch
from repro_torch.train import step

# f32 parameters: the same sums over other splits of the batch and the
# vocabulary, over four Adam steps
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_launcher")
    return mesh_workers.finish(
        mesh_workers.start(mesh_workers.launcher, tmp, 2), tmp, (2,))


def test_launcher_resumes_a_2x1_checkpoint_on_1x2(ranks, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(step, "default_run_cfg", mesh_workers.f32_run_cfg)
    plain = launch.main(mesh_workers.LAUNCHER + [
        "--steps", "4", "--ckpt-dir", str(tmp_path)])
    want = [(h["loss"], h["grad_norm"]) for h in plain]
    for rank in range(2):
        assert len(ranks[2, rank]["launcher"]) == 4
        close(np.asarray(ranks[2, rank]["launcher"]), np.asarray(want),
              LOSS_TOL)


def test_fsdp_splits_the_parameters_and_trains_as_zero1(ranks):
    """REPRO_FSDP=1 splits every parameter over the data axes as well
    (each rank holds half of the whole at 2x1) and gathers them for the
    forward: the same steps as ZeRO-1's."""
    for rank in range(2):
        fsdp = ranks[2, rank]["fsdp"]
        assert fsdp["blocks"]
        assert fsdp["local"] * 2 == fsdp["whole"]
        close(np.asarray(fsdp["stats"]),
              np.asarray(ranks[2, rank]["launcher"][:2]), LOSS_TOL)


def test_loss_is_the_global_mean_over_split_rows_and_vocab(ranks):
    """With masks whose counts differ between the data ranks, the ranks'
    shares add up to the whole batch's loss (2x1), not to the mean of
    their means; a vocabulary split over `model` gives the same (1x2)."""
    for rank in range(2):
        out = ranks[2, rank]["loss"]
        assert abs(out["means"] - out["plain"]) > 1e-2
        for mesh in ("2x1", "1x2"):
            close(out[mesh], out["plain"], 1e-6)


def test_mesh_refusals(ranks):
    """A mesh of another size than the world's raises; so do prefill,
    serving and decoding under a mesh, naming the roadmap's item, and
    MLA at a tp that does not divide its heads. Every block type's
    train step builds under a mesh."""
    for rank in range(2):
        out = dict(ranks[2, rank]["refusals"])
        out.pop("batch")
        assert "devices, the world" in out.pop("size")
        assert out.pop("trains") == list(mesh_workers.TRAINS)
        assert "3 heads do not split over tp 2" in out.pop("mla")
        assert set(out) == {"make_prefill_step", "make_serve_step",
                            "decode_step", "setup_cross_cache"}
        for call, msg in out.items():
            assert "under a mesh" in msg and "not ported" in msg, call
            assert "ROADMAP Queue 1 item 11" in msg, call


def test_mesh_refuses_a_batch_the_data_ranks_do_not_divide(ranks):
    """--batch 3 at --mesh 2x1 raises: no rank trains on fewer rows than
    the loss's count assumes."""
    for rank in range(2):
        msg = ranks[2, rank]["refusals"]["batch"]
        assert msg is not None
        assert "does not split over 2 data rank" in msg


def test_one_mesh_per_shape_in_a_process_group(ranks):
    """make_production_mesh hands every later caller in the process group
    the mesh it made first for that shape, so runs on one mesh share its
    process groups (NCCL communicators on the card); another shape gets
    its own."""
    for rank in range(2):
        assert ranks[2, rank]["meshes"] == {"same": True, "other": True}


def test_launcher_mesh_needs_cuda_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "stablelm-1.6b", "--reduced", "--mesh",
                     "1x1", "--steps", "1"])
