#!/usr/bin/env python
"""Flagship end-to-end: the cahp-diamond CPU, fully encrypted, on the GPU.

Mirrors test.rb's tfhe-cahp-diamond-00 (test.rb:387-388): runs the test00
program for 8 clock cycles under 128-bit TFHE and checks the decrypted
result packet against the reference golden output.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import logging
logging.basicConfig(level=logging.INFO, format="[%(levelname)s] %(message)s")

import numpy as np

from iyokan_tpu import packet as packet_mod
from iyokan_tpu.circuit.blueprint import Blueprint
from iyokan_tpu.crypto import host
from iyokan_tpu.engine.driver import Frontend
from tests.fixtures import fixture, normalize

CACHE = os.environ.get(
    "IYOKAN_KEY_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 ".key_cache"))
CYCLES = int(os.environ.get("DIAMOND_CYCLES", "8"))
BLUEPRINT = os.environ.get("DIAMOND_BLUEPRINT", "config-toml/cahp-diamond.toml")
IN_FILE = os.environ.get("DIAMOND_IN", "in/test00.in")
GOLDEN = os.environ.get("DIAMOND_OUT", "out/test00-diamond.out")


def main():
    os.makedirs(CACHE, exist_ok=True)
    skf = os.path.join(CACHE, "sk-cggi128")
    # the eval-key cache name is versioned by the bk mask-grid setting: a
    # pre-quantization key (round 2 cache) must not silently ride the
    # truncated slab kernel (see host.genevalkey)
    qtag = f"-q{os.environ.get('IYOKAN_BK_MASK_BITS', '24')}"
    ekf = os.path.join(CACHE, "ek-cggi128" + qtag)
    t0 = time.time()
    if not os.path.exists(skf):
        sk = host.keygen(host.by_name("cggi128"), seed=0)
        sk.save(skf)
    sk = host.SecretKey.load(skf)
    if not os.path.exists(ekf):
        host.genevalkey(sk, seed=1).save(ekf)
    ek = host.EvalKey.load(ekf)
    print(f"keys ready ({time.time()-t0:.1f}s)", flush=True)

    req = packet_mod.PlainPacket.from_toml_file(fixture(IN_FILE))
    t0 = time.time()
    enc = req.encrypt(sk, seed=2)
    print(f"encrypt request ({time.time()-t0:.1f}s)", flush=True)

    bp = Blueprint(fixture(BLUEPRINT))
    t0 = time.time()
    fe = Frontend("tfhe", bp, enc, eval_key=ek)
    print(f"frontend built ({time.time()-t0:.1f}s)", flush=True)

    # Cold run: pays every jit compile (persistent-cached across runs).  The
    # honest steady-state number comes from a WARM second pass below,
    # after the golden check -- in scan mode the first go() also compiles
    # the span program mid-run, so no slice of the cold run is
    # compile-free.
    t0 = time.time()
    fe.go(CYCLES)
    total = time.time() - t0
    nboots = sum(p.n_bootstraps for p in fe.compiled.levels)
    print(f"{CYCLES} encrypted cycles in {total:.1f}s cold "
          f"(incl. all compiles; {nboots} bootstraps/cycle)", flush=True)

    if os.environ.get("DIAMOND_STAGES", "1") != "0":
        # one extra (discarded) settle with per-stage sync timers: where a
        # cycle's wall clock goes.  The synced sweep disables level fusion,
        # so its total exceeds the fused steady-state cycle time above.
        # run the synced sweep twice: the first call compiles the unfused
        # per-level programs (whose compiles would otherwise be booked as
        # "gates" time); the second measures.
        fe.engine.settle(fe.vals, fe.rams, fe.roms, stages={})
        stages = {}
        t0 = time.time()
        fe.engine.settle(fe.vals, fe.rams, fe.roms, stages=stages)
        stot = time.time() - t0
        print(f"per-stage breakdown (one synced, unfused cycle, "
              f"{stot:.2f}s):", flush=True)
        for cat in ("gates", "simple", "cb", "rom_read", "ram_read",
                    "ram_write"):
            if cat in stages:
                print(f"  {cat:>10}: {stages[cat]:6.2f}s "
                      f"({100*stages[cat]/stot:4.1f}%)", flush=True)
        over = stot - sum(stages.values())
        print(f"  {'dispatch':>10}: {over:6.2f}s ({100*over/stot:4.1f}%)",
              flush=True)

        period = int(os.environ.get("IYOKAN_RAM_REFRESH_PERIOD", "16"))
        if period > 1:
            # same breakdown for a SKIP-refresh cycle (the common case
            # under the periodic schedule: period-1 of every period)
            fe.engine.settle(fe.vals, fe.rams, fe.roms, stages={},
                             ram_refresh=False)
            skip_stages = {}
            t0 = time.time()
            fe.engine.settle(fe.vals, fe.rams, fe.roms, stages=skip_stages,
                             ram_refresh=False)
            sk_tot = time.time() - t0
            print(f"per-stage breakdown (one synced, unfused SKIP-refresh "
                  f"cycle, {sk_tot:.2f}s; schedule: {period-1} of every "
                  f"{period}):", flush=True)
            for cat in ("gates", "simple", "cb", "rom_read", "ram_read",
                        "ram_write"):
                if cat in skip_stages:
                    print(f"  {cat:>10}: {skip_stages[cat]:6.2f}s "
                          f"({100*skip_stages[cat]/sk_tot:4.1f}%)",
                          flush=True)

    res = fe.make_result_packet().decrypt(sk)
    want = packet_mod.PlainPacket.from_toml_file(fixture(GOLDEN))
    ok = normalize(res) == normalize(want)

    # Warm pass: every program (cycle fn, scan span, tail) is compiled
    # now; run CYCLES more (the CPU state just marches on -- only wall
    # time matters here) and divide, after the device has finished.
    t0 = time.time()
    fe.go(CYCLES)
    fe.engine.block_until_ready(fe.vals)
    steady = (time.time() - t0) / CYCLES
    print(f"warm pass: {steady:.2f}s/cycle, {nboots} bootstraps/cycle -> "
          f"{nboots/steady:.0f} effective bootstraps/s", flush=True)

    import json
    print(json.dumps({
        "metric": "diamond_sec_per_cycle", "value": round(steady, 3),
        "unit": "s/cycle", "cycles": CYCLES,
        "cold_total_s": round(total, 1),
        "bootstraps_per_cycle": nboots, "match": ok,
        "fuse": os.environ.get("IYOKAN_FUSE_LEVELS", "8"),
    }), flush=True)
    print("RESULT:", "MATCH" if ok else "MISMATCH")
    if not ok:
        for name in sorted(want.bits):
            got_b = res.bits.get(name)
            print(f"  {name}: got {None if got_b is None else list(got_b)} "
                  f"want {list(want.bits[name])}")
        sys.exit(1)


if __name__ == "__main__":
    main()
