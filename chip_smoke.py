#!/usr/bin/env python
"""Smoke run of the encrypted main path on the GPU, in one process.

    python chip_smoke.py [--seed N]      # phases 1-4 on one card
    python chip_smoke.py --four          # the sharded circuit on 4 cards

Phases (each prints its lines; any failure exits non-zero):
  1. device: JAX's first device must be a GPU; prints its kind, the device
     count and `nvidia-smi --query-gpu=name,power.limit`.
  2. kernel: one Toeplitz-slab external-product step at cggi128 widths
     (N=1024, l=3, lb=2, 3 limbs) on 32 gate rows, bit-identical to the
     numpy reference polymul.tkey_extprod_ref.
  3. nand: batched NAND gate bootstraps at cggi128, G=2048 and G=128, every
     output decrypted, 0 wrong; ms per batch.
  4. circuit: keys through `iyokan-packet genkey/genevalkey`, a request from
     --seed through toml2packet + enc, 4 cycles of `iyokan tfhe` on
     tests/data/smoke-ram-8-16-16.toml (a MUX-gate RAM and a CMUX RAM,
     8-16-16), dec, and the same request through `iyokan plain`: the two
     result packets must be equal bit for bit.
With --four, only the circuit phase runs, with a 4-device mesh active:
every gate bootstrap of at least 32 rows, and every slab step inside it,
must run split over the 4 devices as XLA partitioned it; the cycles between
the first and the last must compile nothing; and the result must again
equal the plain engine's.

The last line of a passing run is the JSON record
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BLUEPRINT = os.path.join(REPO, "tests", "data", "smoke-ram-8-16-16.toml")
CYCLES = 4


def smi_line() -> str:
    """Card name and power limit, read by a child that does not import JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------- #
# phase 2: one slab step at real widths against the numpy reference
# --------------------------------------------------------------------------- #

def kernel_check(p, G: int = 32, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iyokan_tpu.crypto import ops, polymul

    L, lb = ops.tkey_default_config(p)
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (1, 2 * p.l, 2, p.N), dtype=np.uint32)
    slab = polymul.tkey_kernel_key(rows, p, L, lb=lb)[0]
    diff = rng.integers(0, 1 << 32, (G, 2, p.N), dtype=np.uint32)
    got = np.asarray(jax.jit(lambda d, s: ops.slab_extprod(d, s, p))(
        jnp.asarray(diff), jnp.asarray(slab)))
    digits = np.concatenate(
        [np.asarray(ops.gadget_digits(jnp.asarray(diff[:, 0]), p.l, p)),
         np.asarray(ops.gadget_digits(jnp.asarray(diff[:, 1]), lb, p))],
        axis=1)
    sel = np.concatenate([rows[:, : p.l], rows[:, p.l : p.l + lb]], axis=1)
    want = polymul.tkey_extprod_ref(digits, polymul.tkey_prep1(sel, p, L)[0],
                                    L)
    n_diff = int((got != want).sum())
    print(f"kernel: slab step N={p.N} l={p.l} lb={lb} limbs={L} G={G}: "
          f"{n_diff} of {got.size} words differ from tkey_extprod_ref",
          flush=True)
    check(n_diff == 0, "slab step differs from the reference")


# --------------------------------------------------------------------------- #
# phase 4: the circuit through the CLIs
# --------------------------------------------------------------------------- #

def small_blueprint(workdir: str) -> str:
    """The smoke blueprint cut to 3-4-4 memories (toy-size rehearsals of
    the card runs on CPU); returns its path in workdir."""
    with open(BLUEPRINT) as f:
        text = f.read()
    for a, b in (("in_addr_width = 8", "in_addr_width = 3"),
                 ("_width = 16", "_width = 4"),
                 ("[0:7]", "[0:2]"), ("[0:15]", "[0:3]")):
        check(a in text, f"smoke blueprint lacks {a!r}")
        text = text.replace(a, b)
    path = os.path.join(workdir, "smoke-ram-3-4-4.toml")
    with open(path, "w") as f:
        f.write(text)
    return path


def make_keys(params_name: str, workdir: str):
    """Secret + eval key (with CB) through the packet CLI; returns paths."""
    from iyokan_tpu.cli import packet_cli

    sk = os.path.join(workdir, "secret.key")
    ek = os.path.join(workdir, "eval.key")
    t0 = time.perf_counter()
    packet_cli.main(["genkey", "--type", "tfhepp", "--params", params_name,
                     "--seed", "0", "-o", sk])
    packet_cli.main(["genevalkey", "-i", sk, "-o", ek, "--seed", "1"])
    return sk, ek, time.perf_counter() - t0


def request_toml(blueprint: str, cycles: int, seed: int) -> str:
    """A request for the smoke blueprint from a seed: random initial RAM
    contents and `cycles` cycles of every circular input stream."""
    import numpy as np

    from iyokan_tpu import packet as packet_mod
    from iyokan_tpu.circuit.blueprint import Blueprint

    bp = Blueprint(blueprint)
    rng = np.random.default_rng(seed)
    pkt = packet_mod.PlainPacket(num_cycles=cycles)
    for ram in bp.builtin_rams:
        pkt.ram[ram.name] = rng.integers(
            0, 2, (1 << ram.in_addr_width) * ram.out_rdata_width,
            dtype=np.uint8)
    inputs = sorted({name for (name, _), port in bp.at_ports.items()
                     if port.kind == "input"})
    for name in inputs:
        pkt.bits[name] = rng.integers(
            0, 2, bp.at_port_widths[name] * cycles, dtype=np.uint8)
    return pkt.to_toml()


def run_circuit(sk: str, ek: str, blueprint: str, cycles: int, seed: int,
                workdir: str) -> dict:
    """Request from seed -> enc -> `iyokan tfhe` -> dec, and the same
    request through `iyokan plain`.  Returns timings; raises SmokeFailure
    unless the two result packets are equal bit for bit."""
    import numpy as np

    from iyokan_tpu import packet as packet_mod
    from iyokan_tpu.cli import iyokan_cli, packet_cli

    def path(name):
        return os.path.join(workdir, name)

    with open(path("req.toml"), "w") as f:
        f.write(request_toml(blueprint, cycles, seed))
    packet_cli.main(["toml2packet", "-i", path("req.toml"),
                     "-o", path("req.plain")])
    packet_cli.main(["enc", "--key", sk, "-i", path("req.plain"),
                     "-o", path("req.enc")])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        iyokan_cli.main(["tfhe", "--blueprint", blueprint, "--evalkey", ek,
                         "-i", path("req.enc"), "-o", path("res.enc"),
                         "-c", str(cycles), "--stdout-csv", "--quiet"])
    wall = time.perf_counter() - t0
    packet_cli.main(["dec", "--key", sk, "-i", path("res.enc"),
                     "-o", path("res.plain")])
    iyokan_cli.main(["plain", "--blueprint", blueprint,
                     "-i", path("req.plain"), "-o", path("want.plain"),
                     "-c", str(cycles), "--quiet"])
    got = packet_mod.PlainPacket.load(path("res.plain"))
    want = packet_mod.PlainPacket.load(path("want.plain"))
    report, n_bad = [], 0
    for field in ("ram", "bits"):
        g, w = getattr(got, field), getattr(want, field)
        check(sorted(g) == sorted(w), f"{field} names {sorted(g)} != "
              f"{sorted(w)}")
        for name in sorted(w):
            n = int((np.asarray(g[name]) != np.asarray(w[name])).sum())
            report.append(f"{field}.{name}: {n}/{len(w[name])} bits differ")
            n_bad += n
    # per-cycle wall times from the CLI's --stdout-csv lines
    marks = {}
    for line in out.getvalue().splitlines():
        parts = line.split(",")
        if len(parts) == 3 and parts[1] in ("start", "end"):
            marks[(parts[1], int(parts[2]))] = float(parts[0])
    spans = [(marks[("start", c)], marks[("end", c)])
             for c in range(1, cycles + 1)]
    print("circuit: " + "; ".join(report), flush=True)
    check(n_bad == 0, "encrypted result differs from the plain engine")
    return {"wall_s": wall, "per_cycle_s": [b - a for a, b in spans],
            "cycle_spans": spans}


def circuit_phase(p, seed: int, workdir: str, blueprint: str = BLUEPRINT,
                  cycles: int = CYCLES, keys=None) -> dict:
    """Phase 4 (and the body of --four).  keys: (sk_path, ek_path) made
    earlier in this process, or None to make them here."""
    if keys is None:
        sk, ek, keygen_s = make_keys(p.name, workdir)
        print(f"circuit: keygen (with CB) {keygen_s:.1f} s", flush=True)
    else:
        sk, ek = keys
    # the periodic full-store RAM refresh runs on the last cycle
    os.environ.setdefault("IYOKAN_RAM_REFRESH_PERIOD", str(cycles))
    r = run_circuit(sk, ek, blueprint, cycles, seed, workdir)
    pc = r["per_cycle_s"]
    # cycle 1 compiles the cycle; the last one also compiles and runs the
    # full-store refresh; the cycles between are the steady state
    steady = pc[1:-1] or pc[-1:]
    s_cycle = sum(steady) / len(steady)
    print(f"circuit: {os.path.basename(blueprint)} x{cycles} cycles equal "
          f"to plain; per-cycle wall s {[round(x, 3) for x in pc]}: "
          f"cycle 1 (compile + run) {pc[0]:.2f}, s/cycle {s_cycle:.3f} "
          f"(cycles 2-{max(2, cycles - 1)}), last cycle (with full-store "
          f"refresh and its compile) {pc[-1]:.2f}", flush=True)
    return {"s_per_cycle": s_cycle, "first_cycle_s": pc[0],
            "cycle_spans": r["cycle_spans"]}


# --------------------------------------------------------------------------- #
# --four: level batches sharded over a 4-device mesh
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def watch_bootstraps(seen: list, compiles: list):
    """Record how XLA lays out the gate bootstraps' work as it partitions
    each program: the sharding of every slab step's product (inside the
    635-step loop) and of every gate bootstrap's output, as (kind, global
    rows, devices holding a part, fully replicated).  Also stamp the wall
    time of every program compiled meanwhile.  The persistent compile cache
    is off inside: a program loaded from it is not partitioned again."""
    import jax

    from iyokan_tpu.crypto import ops

    def spy(kind, fn):
        def wrapped(*a, **k):
            y = fn(*a, **k)
            jax.debug.inspect_array_sharding(
                y, callback=lambda s, rows=y.shape[0]: seen.append(
                    (kind, rows, len(s.device_set), s.is_fully_replicated)))
            return y
        return wrapped

    def on_event(event, _secs, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(time.time())

    orig = ops.slab_extprod, ops.gate_bootstrap_tlwe1
    cache = jax.config.jax_enable_compilation_cache
    ops.slab_extprod = spy("step", orig[0])
    ops.gate_bootstrap_tlwe1 = spy("bootstrap", orig[1])
    jax.config.update("jax_enable_compilation_cache", False)
    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        yield
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
        jax.config.update("jax_enable_compilation_cache", cache)
        ops.slab_extprod, ops.gate_bootstrap_tlwe1 = orig


def four_phase(p, seed: int, workdir: str, blueprint: str = BLUEPRINT,
               cycles: int = CYCLES, n_devices: int = 4) -> dict:
    """The circuit with an n_devices mesh active.  Fails unless every gate
    bootstrap of at least n_devices * 8 rows ran split over all the
    devices, slab steps included, and the cycles between the first and the
    last compiled nothing."""
    import jax

    from iyokan_tpu.parallel import mesh as mesh_mod

    check(len(jax.devices()) >= n_devices,
          f"--four needs {n_devices} devices, found {len(jax.devices())}")
    seen, compiles = [], []
    mesh_mod.set_mesh(mesh_mod.make_mesh(n_devices))
    try:
        with watch_bootstraps(seen, compiles):
            r = circuit_phase(p, seed, workdir, blueprint, cycles)
    finally:
        mesh_mod.set_mesh(None)
    split = {k: sorted({rows for kind, rows, n, whole in seen
                        if kind == k and n == n_devices and not whole})
             for k in ("step", "bootstrap")}
    whole = {k: sorted({rows for kind, rows, n, whole in seen
                        if kind == k and (whole or n != n_devices)})
             for k in ("step", "bootstrap")}
    print(f"four: gate bootstrap outputs split over {n_devices} devices, "
          f"rows {split['bootstrap']}; slab-step products split, rows "
          f"{split['step']}; whole on every device, rows "
          f"{whole['bootstrap']}", flush=True)
    check(bool(split["bootstrap"])
          and set(split["bootstrap"]) <= set(split["step"]),
          "the slab steps did not run split as the bootstraps did")
    check(all(rows < n_devices * 8 for rows in whole["bootstrap"]),
          f"bootstraps of {whole['bootstrap']} rows ran whole on every "
          "device")
    per_cycle = [sum(a <= t <= b for t in compiles)
                 for a, b in r["cycle_spans"]]
    print(f"four: programs compiled per cycle {per_cycle}", flush=True)
    check(not any(per_cycle[1:-1]),
          "a cycle between the first and the last compiled again")
    for d in jax.devices()[:n_devices]:
        stats = d.memory_stats() or {}
        print(f"four: {d} peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use')}", flush=True)
    return r


# --------------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="only the circuit, sharded over a 4-device mesh")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    if dev["platform"] != "gpu":
        print("FAIL: JAX found no GPU", flush=True)
        return 1
    print(f"device: nvidia-smi: {smi_line()}", flush=True)

    sys.path.insert(0, REPO)
    from iyokan_tpu import params as params_mod

    p = params_mod.CGGI128
    try:
        with tempfile.TemporaryDirectory() as workdir:
            if args.four:
                four_phase(p, args.seed, workdir)
            else:
                run_one_card(p, args.seed, workdir)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"device: peak_bytes_in_use {peak}", flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


def run_one_card(p, seed: int, workdir: str) -> None:
    import bench
    from iyokan_tpu.crypto import host, ops

    kernel_check(p)

    sk, ek, keygen_s = make_keys(p.name, workdir)
    print(f"nand: keygen (with CB) {keygen_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    # the engine's DeviceKeys LRU serves this same build to phase 4
    keys = ops.DeviceKeys.from_evalkey(host.EvalKey.load(ek), with_cb=True)
    print(f"nand: device keys (slab build + transfer) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    secret = host.SecretKey.load(sk)
    for G, reps in ((2048, 5), (128, 10)):
        ms, n_wrong, compile_s = bench.time_nand(keys, secret, G, reps)
        print(f"nand: G={G}: {n_wrong} wrong of {G}; compile+first "
              f"{compile_s:.1f} s; {ms:.3f} ms/batch = "
              f"{G / ms * 1e3:.1f} gates/s", flush=True)
        check(n_wrong == 0, f"{n_wrong} wrong NANDs at G={G}")
    del keys
    circuit_phase(p, seed, workdir, keys=(sk, ek))


if __name__ == "__main__":
    sys.exit(main())
