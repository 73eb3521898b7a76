"""The harness's whole run (all but its look for a card) on the CPU, on
the small cells of ``conftest.py``: sound, it reads ``correct``; with the
timed path broken underneath, each fault a cell can have makes it read
not correct:

- a step that returns its state unchanged (the plain RK4 step or SIMPLE
  iteration hands back its input);
- half of the batch left out (a round solves its first half of lanes and
  hands the others the first lane's answer, as a mean of what it solved);
- an answer altered where it is produced (one interior value of the final
  state moved by 1e-3, or a reported validation number by 1e-6);
- a wrong pressure step in an FV cell, which converges to a state that
  holds the momentum equations with its own fluxes and pressure: face
  fluxes without the compact Rhie-Chow correction.

The exchange between chips has no counterpart: every cell runs on one
card.
"""

import dataclasses

import pytest

from anap3_tpu_torch.models import base, fv as fvm, spectral_sg
from anap3_tpu_torch.models.fv import FVSolver
from anap3_tpu_torch.models.spectral import FSGSolver
from anap3_tpu_torch.parallel import batched
from ldc_bench.run import run_cell

SOLVES = ["tiny-fsg.solve", "tiny-fv.solve"]
ROUNDS = ["tiny-fsg.round", "tiny-fv.round"]


def run(root, cell):
    return run_cell(cell, 20261018, 0.5, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", SOLVES + ROUNDS)
def test_sound_runs_are_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def unchanged_step(monkeypatch):
    rk4_step, fv_step = spectral_sg.rk4_step, fvm.fv_step

    def sg_same(ops, state, tau=None):
        return state, rk4_step(ops, state, tau)[1]

    def fv_same(ops, state):
        return state, fv_step(ops, state)[1]

    monkeypatch.setattr(spectral_sg, "rk4_step", sg_same)
    monkeypatch.setattr(fvm, "fv_step", fv_same)


def half_batch(monkeypatch):
    run_batched = batched.run_batched

    def half(solvers, mesh=None):
        k = max(1, len(solvers) // 2)
        done = run_batched(solvers[:k], mesh)
        for s in solvers[k:]:
            s.state = done[0].state
            if getattr(solvers[0], "levels", None) is not None:
                s.levels = solvers[0].levels
            s._store_results(done[0])
        return done + [done[0]] * (len(solvers) - k)

    monkeypatch.setattr(batched, "run_batched", half)


def altered_state(monkeypatch):
    for cls in (FSGSolver, FVSolver):
        solve = cls.solve

        def altered(self, *a, _solve=solve, **kw):
            _solve(self, *a, **kw)
            u = self.state.u.clone()
            i, j = u.shape[0] // 2, u.shape[1] // 2
            u[i, j] += 1e-3
            self.state = self.state._replace(u=u)

        monkeypatch.setattr(cls, "solve", altered)


def altered_validation(monkeypatch):
    errors = base.CavitySolver.compute_validation_errors

    def altered(self, *a, **kw):
        out = errors(self, *a, **kw)
        out["u_L2_error"] += 1e-6
        return out

    monkeypatch.setattr(base.CavitySolver, "compute_validation_errors",
                        altered)


def averaged_rhie_chow(monkeypatch):
    fv_step = fvm.fv_step

    def averaged(ops, state):
        return fv_step(dataclasses.replace(ops, rhie_chow="averaged"), state)

    monkeypatch.setattr(fvm, "fv_step", averaged)


FV = [c for c in SOLVES + ROUNDS if c.startswith("tiny-fv")]
FAULTS = [(unchanged_step, c) for c in SOLVES + ROUNDS] + \
    [(averaged_rhie_chow, c) for c in FV] + \
    [(half_batch, c) for c in ROUNDS] + \
    [(altered_state, c) for c in SOLVES] + \
    [(altered_validation, c) for c in SOLVES + ROUNDS]


@pytest.mark.parametrize("fault, cell", FAULTS,
                         ids=[f"{f.__name__}-{c}" for f, c in FAULTS])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    out = run(tiny_root, cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
