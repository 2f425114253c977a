"""Headline benchmark: batched gate bootstraps per second on one GPU.

Each homomorphic NAND is a full TFHE gate bootstrap (linear combine ->
635-step blind rotation over N=1024 polynomials -> sample extract -> key
switch to lvl0) at 128-bit parameters, batched over the gate axis.

One process: it finds the GPU, generates keys, times BENCH_REPS batches of
BENCH_G gates (each ending in block_until_ready) and prints one JSON record
naming the device:
  {"metric": "gate_bootstraps_per_sec", "value": ..., "unit": "gates/s",
   "vs_baseline": ..., "device": {...}, "config": {...}, ...}
It exits non-zero, with no record, when JAX finds no GPU, when any NAND
decrypts wrong, or when a phase raises.  A run that is killed prints no
record either: there is no partial result to report.

    python bench.py [--trace DIR]

--trace DIR also traces one more batch with jax.profiler into DIR and
prints its device time per op (tools/trace_summary.py) on stderr.

vs_baseline is against 10_000 gates/s, the order of cuFHE's published V100
gate-bootstrap throughput (the reference's GPU backend,
reference src/iyokan_cufhe.hpp:207-262): a reference line, not a target.
"""

import argparse
import json
import os
import sys
import time

BASELINE_GATES_PER_SEC = 10_000.0


def device_info():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nand_fn(p):
    """jitted (keys, A, B) -> TLWE lvl0 NAND(A, B): one gate bootstrap
    per row, through the engine's own ops and key routing."""
    import jax
    import jax.numpy as jnp

    from iyokan_tpu import gates
    from iyokan_tpu.crypto import ops

    ca, cb, kk = gates.GATE_LIN[gates.NAND]

    @jax.jit
    def nand(keys, A, B):
        G = A.shape[0]
        pre = ops.gate_linear(A, B, jnp.full((G,), ca, jnp.int32),
                              jnp.full((G,), cb, jnp.int32),
                              jnp.full((G,), kk, jnp.int32), p)
        t1 = ops.gate_bootstrap_tlwe1(pre, keys.bk_for(G), p, keys.backend)
        return ops.keyswitch_10(t1, keys.ksk_mat, p)

    return nand


def time_nand(keys, sk, G, reps, seed=2):
    """Compile, check every output of the first batch, then time `reps`
    batches.  Returns (ms_per_batch, n_wrong, compile_s)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iyokan_tpu.crypto import host

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = jnp.asarray(host.encrypt_bits(sk, a, rng))
    B = jnp.asarray(host.encrypt_bits(sk, b, rng))
    nand = nand_fn(keys.params)
    t0 = time.perf_counter()
    out = jax.block_until_ready(nand(keys, A, B))
    compile_s = time.perf_counter() - t0
    n_wrong = int((host.decrypt_bits(sk, np.asarray(out))
                   != 1 - (a & b)).sum())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = nand(keys, A, B)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, n_wrong, compile_s


def trace_nand(keys, sk, G, trace_dir):
    """Trace one NAND batch (after time_nand compiled it) into trace_dir;
    returns the device time per op as text."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iyokan_tpu.crypto import host
    from tools import trace_summary

    rng = np.random.default_rng(3)
    A = jnp.asarray(host.encrypt_bits(
        sk, rng.integers(0, 2, G, dtype=np.uint8), rng))
    nand = nand_fn(keys.params)
    jax.block_until_ready(nand(keys, A, A))
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(nand(keys, A, A))
    jax.profiler.stop_trace()
    return trace_summary.format_summary(trace_summary.summarize(trace_dir))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="trace one more batch into DIR")
    args = ap.parse_args(argv)
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench: no GPU (JAX platform {dev['platform']!r})",
              file=sys.stderr)
        return 1
    from iyokan_tpu import params as params_mod
    from iyokan_tpu.crypto import host, ops

    cfg = {
        "params": os.environ.get("BENCH_PARAMS", "cggi128"),
        "G": int(os.environ.get("BENCH_G", "2048")),
        "reps": int(os.environ.get("BENCH_REPS", "3")),
    }
    cfg.update({k: v for k, v in sorted(os.environ.items())
                if k.startswith("IYOKAN_")})
    p = params_mod.by_name(cfg["params"])
    t0 = time.perf_counter()
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = ops.DeviceKeys.from_evalkey(ek, with_cb=False)
    setup_s = time.perf_counter() - t0
    ms, n_wrong, compile_s = time_nand(keys, sk, cfg["G"], cfg["reps"])
    if n_wrong:
        print(f"bench: {n_wrong}/{cfg['G']} wrong NAND results",
              file=sys.stderr)
        return 1
    rate = cfg["G"] / ms * 1e3
    if args.trace:
        print(trace_nand(keys, sk, cfg["G"], args.trace), file=sys.stderr,
              flush=True)
    print(json.dumps({
        "metric": "gate_bootstraps_per_sec", "value": rate,
        "unit": "gates/s", "vs_baseline": rate / BASELINE_GATES_PER_SEC,
        "device": dev, "config": cfg, "ms_per_batch": ms,
        "wrong_results": n_wrong, "keygen_s": keygen_s,
        "key_setup_s": setup_s, "compile_s": compile_s,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
