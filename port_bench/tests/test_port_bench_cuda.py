"""A short run of a cell through the command, on the card."""

import json
import subprocess
import sys

import pytest

from port_bench.harness import cell as cell_mod


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_prints_the_contract_line(card):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "strokes-1080p.drift",
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=cell_mod.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"]
    assert {"frames_per_s", "frame_interval_p99_ms", "setup_s"} <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    """Without a card the command exits 2 and prints no result line."""
    run_py = str(cell_mod.BENCH_DIR / "run.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False;"
            f"sys.argv = [{run_py!r}, '--workload', 'strokes-1080p.drift'];"
            f"runpy.run_path({run_py!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=cell_mod.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_only_the_benchmark_no_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench/, the
    command exits with an error and prints no result."""
    import shutil

    shutil.copy(cell_mod.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cell_mod.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "sys.argv = ['port_bench/run.py', '--workload', 'strokes-1080p.drift'];"
            "runpy.run_path('port_bench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "contrast_renderer_tpu_torch" in out.stderr
