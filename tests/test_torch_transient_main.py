"""Port parity of the transient entry points: time_ocean and run_ams end
to end on a bundle of the tiny 2DMOC ocean (3x4x4, direct solves) in the
JAX package and in the port, on the CPU; the transient states that the
port writes and the JAX package does not (ROADMAP queue 3); and the
entry points' default device."""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_continuation_2dmoc import make_2dmoc_ocean
from test_torch_transient import (DIRECT, NOISY, _columns_close, _oceans,
                                  _rest, _table, oceans)  # noqa: F401
from iemic_tpu import transient as jtr
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch import transient as ttr
from iemic_tpu_torch.main import run_ams, time_ocean
from iemic_tpu_torch.utils import logging as tlog


def _bundle(path, solver, **files):
    """A run bundle of the tiny 2DMOC ocean in path."""
    from iemic_tpu_torch.config import ParameterList, write_xml
    jo = make_2dmoc_ocean(n=3, m=4, l=4)
    thcm = jo.params.sublist("THCM").to_dict()
    thcm["Starting Parameters"].update(dict(NOISY))
    os.makedirs(path, exist_ok=True)
    write_xml(ParameterList("Ocean", {"Save state": False, "THCM": thcm}),
              os.path.join(path, "ocean_params.xml"))
    write_xml(ParameterList("Solver parameters", dict(solver)),
              os.path.join(path, "solver_params.xml"))
    for name, pars in files.items():
        write_xml(ParameterList(name, pars),
                  os.path.join(path, name + ".xml"))
    return str(path)


def _jax_main(main, workdir):
    """A JAX entry point run in workdir: it changes directory and keeps
    its log files, which this undoes."""
    cwd = os.getcwd()
    jlog.set_verbose(True)
    tlog.set_verbose(True)
    try:
        return main([workdir])
    finally:
        os.chdir(cwd)
        jlog.set_log_stream(sys.stdout)
        jlog.set_cdata_file(None)


def test_time_ocean_matches_jax(tmp_path):
    """time_ocean end to end on a bundle in both packages: status 0 and
    tdata.txt to 1e-8."""
    from iemic_tpu.main import time_ocean as jtime_ocean
    pars = {"theta": 1.0, "time step": 0.05, "adaptive time steps": True,
            "number of time steps": 3, "Newton tolerance": 1e-9,
            "HDF5 output frequency": 0}
    jdir = _bundle(tmp_path / "jax", DIRECT, timestepper_params=pars)
    tdir = _bundle(tmp_path / "port", DIRECT, timestepper_params=pars)
    assert _jax_main(jtime_ocean.main, jdir) == 0
    assert time_ocean.main([tdir, "--device", "cpu"]) == 0
    tj = _table(os.path.join(jdir, "tdata.txt"))
    tt = _table(os.path.join(tdir, "tdata.txt"))
    assert tj.shape == tt.shape == (3, 8)
    _columns_close(tt, tj, 1e-8)
    assert os.path.exists(os.path.join(tdir, "profile_output"))


AMS_PARS = {
    "method": "AMS", "sigma": 20.0, "theta": 1.0, "time step": 0.05,
    "maximum time": 2.0, "number of experiments": 3,
    "number of initial experiments": 3, "maximum iterations": 4,
    "A distance": 0.2, "B distance": 0.8, "score function": "ocean",
    "maximum Newton iterations": 20, "Newton tolerance": 1e-8,
    "random seed": 7, "seed": 3, "write final state": False,
    "solution 1": "sol1.h5", "solution 2": "sol2.h5"}


def _ams_states(path):
    """sol1.h5 (a steady state of a few Newton steps) and sol2.h5 (a
    displaced state), written by the JAX package, as
    tests/test_stochastic_ocean.py::test_ams_runs_on_ocean makes them."""
    jo, _ = _oceans()
    solA = jnp.zeros_like(jo.state)
    for _ in range(5):
        jo.set_state(solA)
        jo.compute_rhs()
        jo.compute_jacobian()
        solA = solA + jo.solve(-jo.rhs)
    rng = np.random.default_rng(3)
    solB = solA + 0.5 * jnp.asarray(
        rng.standard_normal(solA.shape)) * (jnp.abs(solA) + 0.1)
    for name, x in (("sol1.h5", solA), ("sol2.h5", solB)):
        jo.set_state(x)
        jo.save_state_to_file(os.path.join(path, name))


def _logged(info, key):
    return float([ln for ln in open(info) if ln.startswith(key)][-1]
                 .split("=")[1])


def test_run_ams_matches_jax(tmp_path):
    """run_ams end to end on sol1.h5 / sol2.h5 written by the JAX package:
    status 0, probability and MFPT to 1e-10."""
    pytest.importorskip("h5py")
    from iemic_tpu.main import run_ams as jrun_ams
    dirs = [_bundle(tmp_path / p, DIRECT, ams_params=AMS_PARS)
            for p in ("jax", "port")]
    for d in dirs:
        _ams_states(d)
    assert _jax_main(jrun_ams.main, dirs[0]) == 0
    assert run_ams.main([dirs[1], "--device", "cpu"]) == 0
    for key in ("probability", "mfpt"):
        want = _logged(os.path.join(dirs[0], "info_0.txt"), key)
        got = _logged(os.path.join(dirs[1], "info_0.txt"), key)
        assert np.isfinite(got) and abs(got - want) <= 1e-10 * abs(want)
    info = open(os.path.join(dirs[1], "info_0.txt")).read()
    assert "Initialization: 3 / 3" in info


def test_run_ams_takes_states_in_memory(tmp_path):
    """run_ams with "solution 1/2" given as numpy states in memory, in a
    bundle without the .h5 files, does what it does with the files."""
    pytest.importorskip("h5py")
    from iemic_tpu_torch.utils import hdf5
    files = _bundle(tmp_path / "files", DIRECT, ams_params=AMS_PARS)
    held = _bundle(tmp_path / "held", DIRECT, ams_params=AMS_PARS)
    _ams_states(files)
    states = {key: hdf5.load_state(os.path.join(files, name))[0]
              for key, name in (("solution 1", "sol1.h5"),
                                ("solution 2", "sol2.h5"))}
    runs = [run_ams.run(files, "cpu")[2],
            run_ams.run(held, "cpu", states=states)[2]]
    assert not any(n.endswith(".h5") for n in os.listdir(held))
    for m in runs:
        assert m.time_steps > 0 and np.isfinite(m.get_probability())
    assert [(m.its, m.time_steps, m.get_probability(), m.get_mfpt())
            for m in runs[1:]] == [(runs[0].its, runs[0].time_steps,
                                    runs[0].get_probability(),
                                    runs[0].get_mfpt())]


def test_port_writes_transient_states_jax_does_not(oceans, tmp_path,
                                                   monkeypatch):
    """ROADMAP queue 3: with "HDF5 output frequency" 1 the port's adaptive
    stepper writes transient_<t>.h5 after each step, which the JAX package
    promises and does not do (its ThetaModel has no save_state_to_file,
    iemic_tpu/transient/adaptive.py:71-74)."""
    pytest.importorskip("h5py")
    from iemic_tpu_torch.utils import hdf5
    jo, to = oceans
    pars = {"theta": 1.0, "time step": 0.05, "number of time steps": 2,
            "Newton tolerance": 1e-9, "HDF5 output frequency": 1}
    for pkg, o, where in ((jtr, jo, "jax"), (ttr, to, "port")):
        _rest(jo, to)
        os.makedirs(tmp_path / where)
        monkeypatch.chdir(tmp_path / where)
        assert pkg.transient_factory(o, dict(pars)).run() == 0
    assert os.listdir(tmp_path / "jax") == []
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == ["transient_0.05.h5", "transient_0.1.h5"]
    state, pars_read = hdf5.load_state(str(tmp_path / "port" / files[-1]))
    assert np.array_equal(state, to.to_flat().numpy())
    assert pars_read["Combined Forcing"] == 1.0


@pytest.mark.parametrize("entry", [time_ocean, run_ams],
                         ids=["time_ocean", "run_ams"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """time_ocean and run_ams run on the card unless asked for the CPU,
    and raise where there is none."""
    assert inspect.signature(entry.run).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main([str(tmp_path)])
        assert os.listdir(tmp_path) == []
