"""The port's real engine on the CPU over the whole reduced campaign
matrix: every scenario's losses are bitwise those of the uninterrupted
reference run, and its ledger fields are bitwise those of the port's
sim-exec mode for the same CampaignCfg (the tensor-free engine's claim
to validity)."""
import dataclasses

import pytest
import torch

from repro_torch.core import campaign

REAL = campaign.CampaignCfg(device="cpu")
SIM = dataclasses.replace(REAL, mode="sim")
NAMES = [sc.name for sc in campaign.reduced_matrix(REAL.dp, REAL.pp)]
# the ledger fields of a ScenarioResult (the reference's
# tests/test_simexec.py KEYS)
KEYS = ("events", "downtime_s", "overlap_s", "train_s",
        "migrated_bytes", "delta_fraction", "lost_iterations",
        "recovery_path", "steps", "resumes", "ckpt_fallbacks",
        "degraded_events", "regrow_events", "loss_parity")


def _campaign(cfg):
    ref = campaign.reference_run(cfg)
    return ref, {sc.name: campaign.run_scenario(sc, cfg, ref)
                 for sc in campaign.reduced_matrix(cfg.dp, cfg.pp)}


@pytest.fixture(scope="module")
def modes():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"real": _campaign(REAL), "sim": _campaign(SIM)}
    finally:
        torch.set_num_threads(n)


def test_reference_runs_commit_every_step(modes):
    for ref, _ in modes.values():
        assert sorted(ref) == list(range(1 + REAL.total_iters))
    losses = [modes["real"][0][k] for k in sorted(modes["real"][0])]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", NAMES)
def test_real_scenario_bitwise_parity_and_sim_ledger(modes, name):
    real, sim = modes["real"][1][name], modes["sim"][1][name]
    assert real.loss_parity and real.loss_max_delta == 0.0
    assert {k: getattr(real, k) for k in KEYS} == \
        {k: getattr(sim, k) for k in KEYS}
