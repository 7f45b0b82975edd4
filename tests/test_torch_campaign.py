"""The port's campaign harness against the JAX package's.

The scenario matrices and the seeded churn traces are the reference's.
The port's real engine on the CPU, from the JAX engine's weights, runs
the uninterrupted reference run and three scenarios of the reduced
matrix (an expected migration, a mid-iteration abort with rollback, a
controller crash inside the switch) beside the JAX engine: losses
within LOSS_TOL, every ledger field of the result and every field of
every MigrationReport identical."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_jax_engine import fast_jax_engine
from repro.core import campaign as jcampaign
from repro.core.engine import PipelineEngine as JEngine
from repro.models import backbone as jbackbone
from repro_torch.convert import params_from_numpy
from repro_torch.core import campaign
from repro_torch.core.engine import PipelineEngine

LOSS_TOL = 1e-5
# the ledger fields of a ScenarioResult (the reference's
# tests/test_simexec.py KEYS)
KEYS = ("events", "downtime_s", "overlap_s", "train_s",
        "migrated_bytes", "delta_fraction", "lost_iterations",
        "recovery_path", "steps", "resumes", "ckpt_fallbacks",
        "degraded_events", "regrow_events", "loss_parity")
SCENARIOS = ("expected-first", "fail-first-pre_reduce",
             "crash-mid-switchover")


def _as_dicts(scenarios):
    return [dataclasses.asdict(sc) for sc in scenarios]


@pytest.mark.parametrize("dp,pp", [(2, 2), (2, 3)])
def test_default_matrix_is_the_reference(dp, pp):
    assert _as_dicts(campaign.default_matrix(dp, pp)) == \
        _as_dicts(jcampaign.default_matrix(dp, pp))


@pytest.mark.parametrize("dp,pp", [(2, 2), (2, 3)])
def test_reduced_matrix_is_the_reference(dp, pp):
    got = _as_dicts(campaign.reduced_matrix(dp, pp))
    assert got == _as_dicts(jcampaign.reduced_matrix(dp, pp))
    assert len(got) == len(campaign.REDUCED_NAMES) == 28


@pytest.mark.parametrize("seed", [7, 1305, 2024])
def test_churn_trace_is_the_reference(seed):
    got = campaign.generate_churn_trace(seed, dp=2, pp=2)
    want = jcampaign.generate_churn_trace(seed, dp=2, pp=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.events[-1].kind == "replenish"


@contextlib.contextmanager
def _last_controllers(mod):
    """Each controller a scenario builds, and the journal-restarted one
    a controller crash hands back, appended as they appear: the last
    one holds the scenario's engine and reports."""
    seen = []
    build, inject = mod.build_controller, mod._inject

    def build_and_keep(*args, **kw):
        seen.append(build(*args, **kw))
        return seen[-1]

    def inject_and_keep(ctl, sc):
        out = inject(ctl, sc)
        if isinstance(out, tuple):
            seen.append(out[1])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "build_controller", build_and_keep)
        mp.setattr(mod, "_inject", inject_and_keep)
        yield seen


@contextlib.contextmanager
def _jax_programs_shared():
    """Inside fast_jax_engine: every JAX engine of one run shape takes
    the programs the first one built (the same programs, built from the
    same config, shapes and Adam settings). A charge is the engine's
    own compile_charge, the modeled constant with sim_compile_seconds
    set, so losses and ledgers are what they would be without this."""
    built = {}
    build = JEngine.compile_role

    def shared(self, stage, fresh=False, charge=None):
        key = (repr(self.cfg), self.pp, self.mb_size, self.seq_len,
               self.use_flat_buffers, repr(self.adam), stage)
        if key not in built:
            built[key] = build(self, stage, fresh)
        role = self._role_cache[stage] = built[key]
        if charge is not None:
            self.clock.advance(self.compile_charge(role), f"jit:{stage}",
                               lane=charge)
        return role

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "compile_role", shared)
        yield


def _campaign(mod, cfg):
    by_name = {sc.name: sc for sc in mod.reduced_matrix(cfg.dp, cfg.pp)}
    with _last_controllers(mod) as seen:
        ref = mod.reference_run(cfg)
        out = {"reference": ref}
        for name in SCENARIOS:
            res = mod.run_scenario(by_name[name], cfg, ref)
            ctl = seen[-1]
            out[name] = {
                "result": {k: getattr(res, k) for k in KEYS},
                "losses": list(ctl.engine.losses),
                "reports": [dataclasses.asdict(r) for r in ctl.reports]}
    return out


@pytest.fixture(scope="module")
def runs():
    cfg = campaign.CampaignCfg(device="cpu")
    jcfg = jcampaign.CampaignCfg()
    with fast_jax_engine(), _jax_programs_shared():
        ref = _campaign(jcampaign, jcfg)
    # the JAX engine's own initial weights, as numpy: the port's engine
    # draws its weights from them instead of from its seed
    jarch = jcampaign.tiny_gpt(layers=jcfg.layers, d=jcfg.d_model,
                               heads=jcfg.heads, vocab=jcfg.vocab)
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jarch, jax.random.PRNGKey(jcfg.seed), tp=1, dtype=jnp.float32))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PipelineEngine, "_init_full",
                   lambda self: params_from_numpy(full_np, "cpu"))
        port = _campaign(campaign, cfg)
    torch.set_num_threads(n)
    return ref, port


def test_reference_run_losses_within_tolerance(runs):
    ref, port = runs
    assert sorted(port["reference"]) == sorted(ref["reference"]) == \
        list(range(1 + campaign.CampaignCfg().total_iters))
    np.testing.assert_allclose(
        [port["reference"][k] for k in sorted(ref["reference"])],
        [ref["reference"][k] for k in sorted(ref["reference"])],
        rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_losses_within_tolerance(runs, name):
    ref, port = runs
    assert len(port[name]["losses"]) == len(ref[name]["losses"])
    np.testing.assert_allclose(port[name]["losses"], ref[name]["losses"],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_ledgers_identical(runs, name):
    ref, port = runs
    assert port[name]["result"] == ref[name]["result"]
    assert port[name]["result"]["loss_parity"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_reports_identical(runs, name):
    ref, port = runs
    assert port[name]["reports"]
    assert port[name]["reports"] == ref[name]["reports"]
