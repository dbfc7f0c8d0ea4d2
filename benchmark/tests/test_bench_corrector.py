"""The ocean96-corrector cell's driver, check and control.

On the CPU at the masked 8x8x4 fixture: a whole run through
``harness.runner.run_cell`` comes out correct and refuses to report a
time; the same run with the timed path broken underneath (the corrector
leaving its state unchanged, F altered where it is assembled, a solve's
answer altered) comes out not correct; the reference in f32 in the
program's place fails the check.  On the card (marked ``cuda``): the f32
control at the cell's own size, on three seeds.
"""

import time

import pytest
import torch

from conftest import ocean_fixture_config

CELL = "ocean96-corrector"
SEED = 2 ** 33 + 5


def _run(seconds=0.1, trace=False, device="cpu"):
    from harness import registry, runner
    spec = registry.benchmark()
    config = ocean_fixture_config() if device == "cpu" else None
    return runner.run_cell(CELL, SEED, seconds, trace,
                           t_process=time.perf_counter(), device=device,
                           spec=spec, config=config), spec


@pytest.fixture(scope="module")
def sound():
    torch.set_num_threads(2)
    return _run()


def test_a_sound_run_is_correct(sound):
    run, _ = sound
    assert run.correct, run.numbers
    assert run.failed == 0 and len(run.units) == 1
    assert run.numbers["F_gap"] < 1e-13 and run.numbers["J_gap"] < 1e-13
    assert run.numbers["update_gap"] < 1e-13


def test_no_time_is_reported_off_the_card(sound):
    from harness import runner
    run, spec = sound
    with pytest.raises(RuntimeError, match="off the card"):
        runner.result(run, spec)


def test_the_traced_run_reads_its_spans_and_counters():
    from harness import registry
    torch.set_num_threads(2)
    run, spec = _run(trace=True)
    assert run.correct
    read = {m["name"]: registry.metric(m["name"]).read(run)
            for m in registry.metrics_of(spec, "per_layer", CELL)}
    assert read["mv_per_newton.ocean"] == sum(run.spans.counts["mv"]) > 0
    assert read["assembly_s.ocean"] > 0 and read["s_per_mv.ocean"] > 0
    # no kernel ran off the card: its roofline is left out, not 0
    assert read["stencil_roofline_pct"] is None


def _broken(monkeypatch, fault):
    from iemic_tpu_torch.continuation import Continuation
    from iemic_tpu_torch.models.ocean import Ocean
    if fault == "state unchanged":
        inner = Continuation.newton_corrector

        def corrector(self):
            x, par = self.model.get_state(), self.par
            status = inner(self)
            self.model.set_state(x)
            self.par = par
            self.model.set_par(self.par_name, par)
            return status
        monkeypatch.setattr(Continuation, "newton_corrector", corrector)
    elif fault == "F altered":
        inner = Ocean._rhs

        def rhs(self, *args, **kwargs):
            F = inner(self, *args, **kwargs)
            return F + 1e-6 * torch.amax(torch.abs(F))
        monkeypatch.setattr(Ocean, "_rhs", rhs)
    elif fault == "solution altered":
        inner = Ocean._solve_operator

        def solve(self, An, b):
            self.sol = 0.5 * inner(self, An, b)
            return self.sol
        monkeypatch.setattr(Ocean, "_solve_operator", solve)


@pytest.mark.parametrize("fault", ["state unchanged", "F altered",
                                   "solution altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    torch.set_num_threads(2)
    _broken(monkeypatch, fault)
    run, _ = _run()
    assert not run.correct, (fault, run.numbers)
    assert run.failed == 1


def test_the_f32_control_fails_at_the_fixture(sound):
    _control_fails(torch.device("cpu"), [SEED], ocean_fixture_config())


def _control_fails(device, seeds, config=None):
    """The reference in f32 in the program's place, at the predicted
    point the program reaches for each seed: one of the compared numbers
    at least must exceed its limit.  Prints the readings."""
    import os
    import tempfile
    from harness import bundle, registry
    from reference import corrector
    spec = registry.benchmark()
    cell = registry.cell(spec, CELL)
    config = registry.config(cell["config"]) if config is None else config
    traffic = registry.traffic(cell["traffic"])
    drv = registry.driver(traffic["driver"])
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            work = bundle.write(config, os.path.join(tmp, "bundle"))
            c = drv.Cell(work, traffic, seed, device)
            x, par = c.x.detach().cpu(), float(c.par)
            c.close()
            got = corrector.control(work, x, par)
        print(f"control f32 seed {seed}: {c.describe()}: {got}")
        assert any(v > traffic["limits"][k] for k, v in got.items()), got


@pytest.mark.cuda
def test_the_f32_control_fails_on_the_card(card):
    _control_fails(card, [3000000011, 3000000012, 3000000013])
