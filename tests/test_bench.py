"""bench.py: one process, GPU only; its timing function at toy size."""

import os
import subprocess
import sys

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_fails_without_gpu():
    """No GPU: non-zero exit and no record (no CPU number under the
    device metric's name)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_PARAMS="toy")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "gate_bootstraps_per_sec" not in r.stdout
    assert "no GPU" in r.stderr


def test_time_nand_toy(toy_sk, toy_dk):
    """The timed NAND batch decrypts right at toy size."""
    ms, n_wrong, compile_s = bench.time_nand(toy_dk, toy_sk, 16, 1)
    assert n_wrong == 0
    assert ms > 0 and compile_s > 0
