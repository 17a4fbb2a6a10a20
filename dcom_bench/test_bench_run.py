"""The command refuses to measure without a card, and no process of the
benchmark loads JAX or the JAX package."""
import json
import shutil
import subprocess
import sys

import pytest

from dcom_bench import bench

ROOT = bench.ROOT


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the host's refusal")
    r = _run(["dcom_bench/run.py", "--workload", "deepseek-7b.actdec-4k",
              "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
             ROOT)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "dcom_bench", tmp_path / "dcom_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(["dcom_bench/run.py", "--workload", "deepseek-7b.actdec-4k",
              "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_no_module_of_the_benchmark_loads_jax_or_repro():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import dcom_bench.run, dcom_bench.harness, dcom_bench.control\n"
        "from dcom_bench import bench\n"
        "for k in ('forward', 'serve_backlog'):\n"
        "    bench.driver(k)\n"
        "m = bench.load_manifest()\n"
        "for p in m['per_layer']:\n"
        "    bench.reader(p['name'])\n"
        "import dcom_bench.reference.actdec, dcom_bench.reference.dkv\n"
        "import repro_torch.serving, repro_torch.runtime.steps\n"
        "print(bench.forbidden_modules(list(sys.modules)))\n"
        % (str(ROOT), str(ROOT / "src")))
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1].replace("'", '"')) \
        == []


def test_reference_imports_nothing_of_the_port():
    for p in (bench.HERE / "reference").glob("*.py"):
        text = p.read_text()
        assert "repro_torch" not in text and "import jax" not in text
        assert "from repro" not in text and "import repro" not in text
