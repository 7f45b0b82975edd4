"""Faster builds of the JAX engine's programs for the port's parity
tests (imported by tests/test_torch_*.py; it holds no tests)."""
import contextlib

import jax
import pytest

import repro.core.engine as jengine_mod
from repro.core.engine import PipelineEngine as JEngine

# XLA's CPU backend at its lowest optimisation level: the reference
# programs build about twice as fast, and tiny shapes lose nothing by it
LOW_OPT = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}


class _LowOptJax:
    """`jax` as the reference engine's module sees it, with jax.jit
    compiling at LOW_OPT."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return jax.jit(fn, compiler_options=LOW_OPT, **kw)


@contextlib.contextmanager
def fast_jax_engine():
    """Inside: the JAX engine builds its programs at LOW_OPT, and a cold
    machine's build (compile_role with fresh=True) takes the engine's
    built programs. They are the same programs, and with
    sim_compile_seconds set the clock charges the same constant either
    way, so losses and ledgers are what they would be without this."""
    build = JEngine.compile_role
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine_mod, "jax", _LowOptJax())
        mp.setattr(JEngine, "compile_role",
                   lambda self, stage, fresh=False, charge=None:
                   build(self, stage, False, charge))
        yield
