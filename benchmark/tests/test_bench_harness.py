"""The harness: what it may import, how it finds what BENCHMARK.json
names, and the roofline's count."""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "iemic_tpu"}


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _run_py():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imported_tops(path)) & FORBIDDEN
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "iemic_tpu_torch" not in set(_imported_tops(path)), path
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.corrector, reference.coupled\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & (FORBIDDEN | {"iemic_tpu_torch"}), tops


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    """A cell run end to end on the CPU at the fixture's size, in a
    process of its own; then the run's own check of sys.modules."""
    code = (
        "import sys, time; t = time.perf_counter()\n"
        "sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import ocean_fixture_config\n"
        "from harness import runner\n"
        "run = runner.run_cell('ocean96-corrector', 7, 0.1, False, "
        "t_process=t, device='cpu', config=ocean_fixture_config())\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('r', %r); m = u.module_from_spec(s)\n"
        "s.loader.exec_module(m)\n"
        "print(run.correct, m.forbidden_modules(), "
        "'iemic_tpu_torch' in sys.modules)"
        % (os.path.join(BENCH, "tests"), BENCH, ROOT,
           os.path.join(BENCH, "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "True [] True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    run = _run_py()
    monkeypatch.setitem(sys.modules, "iemic_tpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "iemic_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["iemic_tpu", "jax"]


def test_outside_a_checkout_it_exits_without_a_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    a code other than 0 and no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ocean96-corrector", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout


def test_without_a_card_it_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ocean96-corrector", "--seed", str(2 ** 40), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "CUDA" in out.stderr


TOY_DRIVER = '''
import torch


class Cell:
    def __init__(self, workdir, traffic, seed, device, spans=None):
        self.n, self.spans, self.done = traffic["n"], spans, 0

    def describe(self):
        return "toy"

    def unit(self):
        self.done += int(torch.ones(self.n).sum())
        if self.spans is not None:
            self.spans.count("toy", self.n)
        return {"done": self.done}

    def after_trace(self, spans):
        pass

    def check(self, records):
        return [{"toy_gap": 0.0} for _ in records]
'''


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    """Adding a configuration, a traffic mix with its driver and a metric
    reader takes new files only."""
    from harness import registry, runner
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), bench / d)
    (bench / "configs" / "toy-config.json").write_text(json.dumps(
        {"name": "toy-config", "source": "none", "reduced": {},
         "assumed": {}, "files": {"toy.xml": {"name": "toy",
                                              "params": {"n": 3}}}}))
    (bench / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"driver": "toy", "n": 5, "trace_units": 1,
         "limits": {"toy_gap": 0.0}}))
    (bench / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (bench / "metrics" / "toy_count.py").write_text(
        "def read(run):\n    return run.spans.counted('toy')\n")
    spec = registry.benchmark(ROOT)
    spec["workloads"].append({"name": "toy-cell", "config": "toy-config",
                              "traffic": "toy-mix", "chips": 1})
    spec["per_layer"].append({"name": "toy_count", "workloads": ["toy-cell"]})
    run = runner.run_cell("toy-cell", 1, 0.05, True,
                          t_process=time.perf_counter(), device="cpu",
                          spec=spec, bench=str(bench))
    assert run.correct and len(run.units) == 1
    assert [m["name"] for m in registry.metrics_of(
        spec, "per_layer", "toy-cell")] == ["toy_count"]
    assert registry.metric("toy_count", str(bench)).read(run) == 5


def test_each_configuration_lists_its_cuts_where_benchmark_json_does():
    """A configuration file's ``reduced`` (each cut with its reason) and
    ``BENCHMARK.json``'s list of it name the same keys."""
    from harness import registry
    for c in registry.benchmark(ROOT)["configs"]:
        body = registry.config(c["name"])
        assert sorted(body["reduced"]) == sorted(c["reduced"]), c["name"]
        assert all(body["reduced"].values()), c["name"]


def test_the_roofline_counts_what_the_inputs_need():
    """On the masked 8x8x4 fixture's Jacobian: the bytes are a hand count
    of the nonzero coefficients whose neighbour lies in the grid, plus x
    and y, in f32; the count is the same on any memory layout of the
    tensor and reads nothing of the kernel's."""
    import tempfile
    from conftest import ocean_fixture_config
    from harness import bundle, roofline
    from reference.ocean import ReferenceOcean
    with tempfile.TemporaryDirectory() as tmp:
        ref = ReferenceOcean(bundle.write(ocean_fixture_config(), tmp))
    gen = torch.Generator().manual_seed(3)
    x = 0.1 * torch.randn(ref.shape, generator=gen, dtype=torch.float64)
    An = ref.jacobian(x, ref.par0)
    A = An.numpy()
    _, _, _, l, m, n = A.shape
    hand = 0
    for p in range(27):
        di, dj, dk = (p % 9) // 3 - 1, (p % 9) % 3 - 1, (0, -1, 1)[p // 9]
        for k in range(l):
            for j in range(m):
                for i in range(n):
                    if 0 <= k + dk < l and 0 <= j + dj < m and (
                            ref.periodic or 0 <= i + di < n):
                        hand += int(np.count_nonzero(
                            A[p, :, :, k, j, i].astype(np.float32)))
    assert 0 < hand < A.size
    assert roofline.stencil_nonzeros(An, ref.periodic) == hand
    assert roofline.stencil_bytes(An, ref.periodic) == \
        4 * (hand + 2 * 6 * l * m * n)
    shuffled = An.permute(5, 4, 3, 2, 1, 0).contiguous().permute(
        5, 4, 3, 2, 1, 0)
    assert not shuffled.is_contiguous()
    assert roofline.stencil_bytes(shuffled, ref.periodic) == \
        roofline.stencil_bytes(An, ref.periodic)
    src = open(os.path.join(BENCH, "harness", "roofline.py")).read()
    assert "stencil_hopper" not in src and "iemic_tpu_torch" not in src


def test_the_units_judged_are_a_sample_drawn_from_the_seed():
    """check_units units kept of any number offered, the same for the
    same seed, every unit where no sample is asked for."""
    from harness.runner import _Sample

    def kept(k, seed, n):
        s = _Sample(k, seed)
        for i in range(n):
            s.offer(i, i)
        return s.records()

    assert kept(None, 1, 7) == list(range(7))
    assert kept(2, 5, 1) == [0]
    picks = kept(2, 2 ** 35, 9)
    assert len(picks) == 2 and picks == sorted(picks)
    assert picks == kept(2, 2 ** 35, 9)
    assert len({tuple(kept(2, s, 9)) for s in range(20)}) > 1
