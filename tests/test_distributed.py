"""Two-process jax.distributed smoke test (CPU).

Exercises parallel/distributed.py for real: two OS processes initialize via
a localhost coordinator, build the global 'gates' mesh spanning both
processes' CPU devices, and run a cross-process psum -- the same
initialization path a multi-host job takes (SURVEY.md section 2.8: the
reference has no distributed backend; this is designed-in here).
"""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from iyokan_tpu.parallel import distributed, mesh as mesh_mod

pid = int(sys.argv[1])
distributed.initialize("localhost:%PORT%", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

mesh = distributed.global_mesh()
assert mesh.devices.size == 4

from jax.sharding import NamedSharding, PartitionSpec as P

sharded = NamedSharding(mesh, P("gates"))
local = jnp.arange(2, dtype=jnp.float32) + 2 * pid
garr = jax.make_array_from_process_local_data(sharded, np.asarray(local), (4,))

out = jax.jit(lambda x: jnp.sum(x), out_shardings=NamedSharding(mesh, P()))(garr)
assert float(out) == 0 + 1 + 2 + 3, float(out)
print("WORKER_OK", pid, flush=True)
"""


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(
        _WORKER.replace("%PORT%", str(port)).replace(
            "os.path.dirname(os.path.dirname(os.path.abspath(__file__)))",
            repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        )
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out
