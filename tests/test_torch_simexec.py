"""The port's tensor-free sim-exec engine against the JAX package's.

Symbolic state stays symbolic: a terabyte of it passes through the
in-memory checkpoint without an allocation. The engine keeps the
reference's two requirements and builds a paper-scale registry arch.
Over the whole reduced campaign matrix and the policy axis, the port's
sim mode gives what the reference's sim mode gives, field for field,
floats bitwise: the two engines make the same SimClock charges from
the same byte sizes, and stamp the same losses."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import campaign as jcampaign
from repro_torch.core import campaign
from repro_torch.core.simexec import SimExecEngine, sym_array, sym_bytes
from repro_torch.train.checkpoint import InMemoryCheckpoint, tree_bytes

SIM = campaign.CampaignCfg(mode="sim")
JSIM = jcampaign.CampaignCfg(mode="sim")
NAMES = [sc.name for sc in campaign.reduced_matrix(SIM.dp, SIM.pp)]
AXIS = [sc.name for sc in campaign.policy_axis_scenarios(
    campaign.reduced_matrix(SIM.dp, SIM.pp))]
TB = 1 << 40


def test_terabyte_state_passes_the_in_memory_checkpoint_unallocated():
    state = {"params": sym_bytes(TB), "opt": sym_bytes(3 * TB),
             "step": np.int32(7)}
    imc = InMemoryCheckpoint()
    imc.put(0, 7, state, ring=[0, 1])
    step, got = imc.get(0)
    assert step == 7
    for key in ("params", "opt"):
        leaf = got[key]
        assert isinstance(leaf, np.ndarray)
        assert leaf.strides == (0,)
        # one element of backing storage, not the logical size
        assert leaf.base is not None and leaf.base.nbytes == 1
    assert got["params"].nbytes == TB
    assert tree_bytes(got) == 4 * TB + 4
    assert imc.bytes_for(1) == 0 and imc.bytes_for(0) == 4 * TB + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sym_array_is_zero_storage(dtype):
    a = sym_array(1 << 33, dtype)
    assert a.nbytes == (1 << 33) * dtype.itemsize
    assert a.strides == (0,)


def test_sim_engine_requires_the_compile_model():
    ctl = campaign.build_controller(SIM, standby_count=1)
    assert isinstance(ctl.engine, SimExecEngine)
    assert ctl.engine.device.type == "meta"
    with pytest.raises(AssertionError, match="sim_compile_seconds"):
        campaign.build_controller(
            dataclasses.replace(SIM, sim_compile_seconds=None),
            standby_count=1)


def test_sim_bootstrap_charges_the_real_engines_bytes():
    """The flat m, v and master in f32 and the int32 opt step, and after
    bootstrap (setup, the recorded iteration, a checkpoint tick, one
    standby warmed) the same device and host ledgers and state bytes
    as the real engine on the CPU."""
    ctls = {mode: campaign.build_controller(
        dataclasses.replace(SIM, mode=mode, device="cpu"), standby_count=1)
        for mode in ("sim", "real")}
    sim = ctls["sim"].engine
    for s in range(SIM.pp):
        assert sim._opt_bytes(s) == 3 * 4 * sim.flat_spec(s).size + 4
    for mode, ctl in ctls.items():
        ctls[mode] = ([(m.mid, m.device.used, m.device.peak, m.host.used)
                       for m in ctl.cluster.machines.values()],
                      [ctl.engine.state_bytes(mid)
                       for mid in ctl.engine.grid.values()],
                      [ctl.imc.bytes_for(mid)
                       for mid in ctl.engine.grid.values()])
    assert ctls["sim"] == ctls["real"]


def test_paper_scale_arch_builds():
    """A named-registry arch on a wider sim cluster: gpt-2.7b at dp 2 x
    pp 4 over 12 machines."""
    cfg = dataclasses.replace(
        SIM, arch="gpt-2.7b", dp=2, pp=4, global_batch=4, seq_len=128,
        machines=8 + 1 + 3, device_capacity_gb=640.0, total_iters=2)
    ref = campaign.reference_run(cfg)
    sc = {s.name: s for s in campaign.reduced_matrix(2, 4)}
    r = campaign.run_scenario(sc["expected-first"], cfg, ref)
    assert r.loss_parity and r.downtime_s > 0
    assert r.migrated_bytes > 2.7e9 * 16 / 4


def _sim_campaign(mod, cfg):
    ref = mod.reference_run(cfg)
    scs = mod.reduced_matrix(cfg.dp, cfg.pp)
    return {"reference": ref,
            "scenarios": {sc.name: mod.run_scenario(sc, cfg, ref).to_dict()
                          for sc in scs},
            "axis": mod.run_policy_axis(scs, cfg, ref)}


@pytest.fixture(scope="module")
def sims():
    return _sim_campaign(jcampaign, JSIM), _sim_campaign(campaign, SIM)


def test_reference_runs_identical(sims):
    ref, port = sims
    assert port["reference"] == ref["reference"]
    assert len(port["reference"]) == 1 + SIM.total_iters


def test_every_reduced_scenario_ran(sims):
    ref, port = sims
    assert list(port["scenarios"]) == list(ref["scenarios"]) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_scenario_identical_to_the_reference(sims, name):
    ref, port = sims
    got, want = port["scenarios"][name], ref["scenarios"][name]
    assert got == want
    assert got["loss_parity"]


@pytest.mark.parametrize("name", AXIS)
def test_policy_axis_row_identical_to_the_reference(sims, name):
    ref, port = sims
    (got,) = [r for r in port["axis"] if r["scenario"] == name]
    (want,) = [r for r in ref["axis"] if r["scenario"] == name]
    assert got == want
    assert got["auto_never_worse"] and got["loss_parity"]


def test_summaries_identical(sims):
    ref, port = sims
    res = lambda run, mod: [mod.ScenarioResult(**d)
                            for d in run["scenarios"].values()]
    assert campaign.summarize(res(port, campaign), port["axis"]) == \
        jcampaign.summarize(res(ref, jcampaign), ref["axis"])
