"""Test configuration.

Tests run on CPU with a virtual 8-device mesh so multi-device sharding is
exercised without accelerator hardware.  Must run before any jax import.
Tests that need a GPU carry the `gpu` marker and skip here (the `gpu_only`
fixture decides at run time, never at import).
"""

import os

# Force CPU, also when jax was imported before this file ran:
# jax.config.update works as long as no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from iyokan_tpu import params as params_mod  # noqa: E402
from iyokan_tpu.crypto import host  # noqa: E402


@pytest.fixture(scope="session")
def toy():
    return params_mod.TOY


@pytest.fixture(scope="session")
def toy_sk(toy):
    return host.keygen(toy, seed=42)


@pytest.fixture(scope="session")
def toy_ek(toy_sk):
    return host.genevalkey(toy_sk, seed=43)


@pytest.fixture(scope="session")
def toy_dk(toy_ek):
    from iyokan_tpu.crypto import ops

    return ops.DeviceKeys.from_evalkey(toy_ek)


@pytest.fixture(scope="session")
def toy_dk_ntt(toy_ek):
    """Device keys on the NTT route (IYOKAN_BR_IMPL=ntt): the exact
    reference the slab route is compared with."""
    from iyokan_tpu.crypto import ops

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IYOKAN_BR_IMPL", "ntt")
        return ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)


@pytest.fixture()
def gpu_only():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run on the card via chip_smoke.py")


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
