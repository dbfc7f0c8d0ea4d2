"""The aquaplanet-theta cell's driver, check and control.

On the CPU at run/aquaplanet cut to 16x8x4: a whole run through
``harness.runner.run_cell`` comes out correct and refuses to report a
time; the same run with the timed path broken underneath (the step
returning its start state, the theta residual or the ocean's Jacobian
altered where it is assembled, a solve's answer altered) comes out not correct; the
reference in f32 in the program's place fails the check.  On the card
(marked ``cuda``): the f32 control at the cell's own size, on three
seeds.
"""

import time

import pytest
import torch

from conftest import aquaplanet_fixture_config

CELL = "aquaplanet-theta"
SEED = 2 ** 33 + 7


def _run(trace=False):
    from harness import registry, runner
    torch.set_num_threads(2)
    spec = registry.benchmark()
    return runner.run_cell(CELL, SEED, 0.1, trace,
                           t_process=time.perf_counter(), device="cpu",
                           spec=spec, config=aquaplanet_fixture_config()), spec


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_a_sound_run_is_correct(sound):
    run, _ = sound
    assert run.correct, run.numbers
    assert run.failed == 0 and len(run.units) == 1
    assert run.numbers["F_gap"] < 1e-13 and run.numbers["update_gap"] < 1e-13


def test_no_time_is_reported_off_the_card(sound):
    from harness import runner
    run, spec = sound
    with pytest.raises(RuntimeError, match="off the card"):
        runner.result(run, spec)


def test_the_traced_run_reads_its_spans_and_counters():
    from harness import registry
    run, spec = _run(trace=True)
    assert run.correct
    read = {m["name"]: registry.metric(m["name"]).read(run)
            for m in registry.metrics_of(spec, "per_layer", CELL)}
    assert read["newton_per_step.coupled"] >= 1
    assert read["mv_per_step.coupled"] >= read["newton_per_step.coupled"]
    assert read["assembly_s.coupled"] > 0
    # the step's residuals (one more than its Newton iterations) and
    # Jacobians, and none of the check's products after the window
    nr = int(read["newton_per_step.coupled"])
    assert len(run.spans.seconds["assembly"]) == 2 * nr + 1


def _broken(monkeypatch, fault):
    from iemic_tpu_torch.models.coupled import CoupledModel
    from iemic_tpu_torch.transient.newton import Newton
    from iemic_tpu_torch.transient.theta import ThetaModel
    if fault == "state unchanged":
        inner = Newton.run

        def run(self, x0):
            inner(self, x0)
            return x0
        monkeypatch.setattr(Newton, "run", run)
    elif fault == "F altered":
        inner = ThetaModel.compute_rhs

        def rhs(self):
            inner(self)
            self.rhs = self.rhs + 1e-6 * torch.amax(torch.abs(self.rhs))
        monkeypatch.setattr(ThetaModel, "compute_rhs", rhs)
    elif fault == "Jacobian altered":
        from iemic_tpu_torch.models.ocean import Ocean
        inner = Ocean.compute_jacobian

        def jacobian(self):
            inner(self)
            self.jac = self.jac * (1.0 + 1e-6)
        monkeypatch.setattr(Ocean, "compute_jacobian", jacobian)
    elif fault == "solution altered":
        inner = CoupledModel.solve

        def solve(self, b):
            self.sol = 0.5 * inner(self, b)
            return self.sol
        monkeypatch.setattr(CoupledModel, "solve", solve)


@pytest.mark.parametrize("fault", ["state unchanged", "F altered",
                                   "Jacobian altered", "solution altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    run, _ = _run()
    assert not run.correct, (fault, run.numbers)
    assert run.failed == 1


def _control_fails(device, seeds, config=None):
    """The reference in f32 in the program's place, at the iterates the
    program's step goes through for each seed: one of the compared
    numbers at least must exceed its limit.  Prints the readings."""
    import os
    import tempfile
    from harness import bundle, registry
    from reference import coupled
    spec = registry.benchmark()
    cell = registry.cell(spec, CELL)
    config = registry.config(cell["config"]) if config is None else config
    traffic = registry.traffic(cell["traffic"])
    drv = registry.driver(traffic["driver"])

    def host(v):
        return v.detach().cpu() if torch.is_tensor(v) else v

    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            work = bundle.write(config, os.path.join(tmp, "bundle"))
            c = drv.Cell(work, traffic, seed, device)
            s = c.unit()
            step = dict(dt=c.dt, theta=c.theta.theta, x0=host(c.x0),
                        final=host(s["final"]),
                        iterates=[{k: host(v) for k, v in it.items()}
                                  for it in s["iterates"]])
            c.close()
            got = coupled.control_theta(work, step)
        print(f"control f32 seed {seed}: {c.describe()}: {got}")
        assert any(v > traffic["limits"][k] for k, v in got.items()), got


def test_the_f32_control_fails_at_the_fixture():
    torch.set_num_threads(2)
    _control_fails(torch.device("cpu"), [SEED], aquaplanet_fixture_config())


@pytest.mark.cuda
def test_the_f32_control_fails_on_the_card(card):
    _control_fails(card, [3000000211, 3000000212, 3000000213])
