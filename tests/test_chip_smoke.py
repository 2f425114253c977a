"""chip_smoke.py and the compile-cache choice, on CPU.

The smoke script's phases are plain functions: the circuit phase and the
four-device phase run here at toy parameters on a smaller copy of the
smoke blueprint (the four-device one on the virtual CPU mesh), which is
the rehearsal of the card runs.  The script itself must refuse to run
without a GPU.
"""

import os
import subprocess
import sys

import pytest

import chip_smoke
import iyokan_tpu
from iyokan_tpu import params as params_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no directory of its
    own (JAX reads the variable).  Unset: one fixed path in the checkout."""
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert iyokan_tpu.compile_cache_dir() is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert iyokan_tpu.compile_cache_dir() == os.path.join(REPO,
                                                              ".jax_cache")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "platform=cpu" in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def small_blueprint(tmp_path):
    return chip_smoke.small_blueprint(str(tmp_path))


def test_smoke_circuit_toy(small_blueprint, tmp_path, monkeypatch):
    """Phase 4 at toy parameters: keys, request, tfhe and plain runs
    through the CLIs; the encrypted result equals the plain one."""
    monkeypatch.setenv("IYOKAN_RAM_REFRESH_PERIOD", "2")
    r = chip_smoke.circuit_phase(params_mod.TOY, 3, str(tmp_path),
                                 small_blueprint, cycles=2)
    assert r["s_per_cycle"] > 0


def test_four_phase_toy_on_cpu_mesh(small_blueprint, tmp_path, monkeypatch):
    """The --four phase on 4 virtual CPU devices: the gate bootstraps and
    their slab steps run split over the mesh, the steady cycle compiles
    nothing, and the result still equals the plain engine's."""
    monkeypatch.setenv("IYOKAN_RAM_REFRESH_PERIOD", "3")
    chip_smoke.four_phase(params_mod.TOY, 4, str(tmp_path),
                          small_blueprint, cycles=3, n_devices=4)


@pytest.mark.gpu
def test_slab_step_cggi128_on_gpu(gpu_only):
    """The card-side kernel check of chip_smoke.py (phase 2)."""
    chip_smoke.kernel_check(params_mod.CGGI128)
