"""iyokan-tpu: a batched TFHE circuit-evaluation engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
virtualsecureplatform/Iyokan: a generic engine that evaluates logic
circuits -- up to complete pipelined CPUs -- over fully homomorphic
encryption (TFHE).

Architectural inversion vs. the reference: the reference schedules *one gate =
one task on a thread* over a dataflow DAG (reference src/iyokan.hpp:829-883);
here the DAG is levelized ahead of time and *all ready gates of a level run
as one batched bootstrap*.  Gate-level task parallelism becomes a batch
axis; priority scheduling collapses into topological levelization; the
CPU<->GPU bridge machinery disappears (single device class); multi-device
scaling is jax.sharding over the gate-batch axis.

Subpackages:
  crypto   -- TFHE over the torus: params, host keygen/enc (numpy),
              batched runtime ops (JAX): Toeplitz-slab blind rotate, NTT,
              key switch, gate bootstrap, circuit bootstrap, CMUX memory ops.
  circuit  -- netlist readers (Yosys JSON / Iyokan-L1 JSON), blueprint TOML,
              MUX ROM/RAM synthesis, levelizing compiler.
  engine   -- plain + TFHE executors and the per-cycle frontend drivers.
  parallel -- multi-device sharding of the batched executors.
  cli      -- `iyokan` and `iyokan-packet` equivalent command-line tools.
"""

# The circuit-bootstrapping path (reference src/iyokan_tfhepp.hpp:194-236)
# runs on a 64-bit torus (TFHEpp lvl2).  All dtypes in this package are
# explicit, so instead of the global x64 flag (which changes default dtypes)
# we only allow explicitly-requested 64-bit dtypes.
import os as _os

import jax

jax.config.update("jax_explicit_x64_dtypes", "allow")

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir():
    """Where this package points JAX's persistent compilation cache, or
    None when JAX_COMPILATION_CACHE_DIR is set (JAX then reads that
    directory itself and no other is set in code).  Otherwise a fixed
    path inside the checkout, so the program writes nothing outside it."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_REPO, ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    jax.config.update("jax_compilation_cache_dir", _cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"
