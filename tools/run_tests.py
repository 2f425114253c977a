#!/usr/bin/env python
"""End-to-end integration driver over the reference test fixtures.

Python port of the reference's test.rb (test.rb:385-548): each test runs
  toml2packet -> [enc ->] iyokan plain|tfhe -> [dec ->] packet2toml
and compares the normalized TOML against the golden output.

Usage:
  python tools/run_tests.py [tags...]        e.g. fast | plain | tfhe | NAME
  --params toy|cggi128   parameter set for tfhe tests (default cggi128)
  --repeat N             repeat the selected set N times
  --fixtures DIR         fixture root (default /root/reference/test)
  --order shuffle|cheap  run order: shuffled (reference test.rb:379 parity,
                         the default) or deterministic cheapest-first (runs
                         bounded by a time window bank the cheap tests first)
  --retries N            attempts per test (default 1)
  --resume-from FILE     previous --results-json record: tests already green
                         there (same params) are skipped and carried over,
                         so the record accumulates across session windows

JAX runs on its default platform; JAX_PLATFORMS=cpu runs plain-only or
toy-parameter selections without a GPU.  Keys are generated once and cached
next to the work dir.  With
--results-json the record is flushed after EVERY test, so a killed session
still leaves a resumable record.
"""

import argparse
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIXTURES = os.environ.get("IYOKAN_FIXTURES", "/root/reference/test")


def sh(args):
    """Invoke a CLI module in-process (a fresh python per command would pay
    the jax import ~8s each; the CLIs are plain main(argv) functions)."""
    import importlib

    mod = importlib.import_module(args[0])
    rc = mod.main(args[1:])
    if rc not in (0, None):
        raise RuntimeError(f"command failed ({rc}): {' '.join(args)}")
    return ""


class Runner:
    def __init__(self, workdir, params):
        self.wd = workdir
        self.params = params
        self.req = os.path.join(workdir, "_req")
        self.res = os.path.join(workdir, "_res")
        self.skey = os.path.join(workdir, "_sk")
        self.bkey = os.path.join(workdir, "_bk")
        self.tests = []

    def fixture(self, p):
        return os.path.join(FIXTURES, p)

    def ensure_keys(self):
        if not os.path.exists(self.skey):
            print(f"generating keys ({self.params})...")
            sh(["iyokan_tpu.cli.packet_cli", "genkey", "--type", "tfhepp",
                "--params", self.params, "--out", self.skey, "--seed", "0"])
            sh(["iyokan_tpu.cli.packet_cli", "genevalkey", "--in", self.skey,
                "--out", self.bkey, "--seed", "1"])

    # ------------------------------------------------------------------ #
    def add(self, name, tags, fn, cost=1.0):
        self.tests.append({"name": name, "tags": set(tags) | {name},
                           "fn": fn, "cost": cost})

    def _compare(self, res_path, out_file):
        from iyokan_tpu import packet as pm
        from tests.fixtures import normalize

        got = pm.PlainPacket.load(res_path)
        want = pm.PlainPacket.from_toml_file(self.fixture(out_file))
        g, w = normalize(got), normalize(want)
        assert g == w, f"mismatch:\n got: {g}\nwant: {w}"

    def add_plain(self, name, blueprint, in_file, out_file, ncycles=-1,
                  tags=()):
        def fn():
            sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
                "--in", self.fixture(in_file), "--out", self.req])
            sh(["iyokan_tpu.cli.iyokan_cli", "plain", "--quiet",
                "--blueprint", self.fixture(blueprint),
                "-i", self.req, "-o", self.res, "-c", str(ncycles)])
            self._compare(self.res, out_file)

        self.add("plain-" + name, set(tags) | {"plain", "fast"}, fn)

    def add_tfhe(self, name, blueprint, in_file, out_file, ncycles,
                 tags=(), cost=1.0):
        def fn():
            self.ensure_keys()
            sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
                "--in", self.fixture(in_file), "--out", self.req])
            sh(["iyokan_tpu.cli.packet_cli", "enc", "--key", self.skey,
                "--in", self.req, "--out", self.req])
            sh(["iyokan_tpu.cli.iyokan_cli", "tfhe", "--quiet",
                "--blueprint", self.fixture(blueprint),
                "--evalkey", self.bkey,
                "-i", self.req, "-o", self.res, "-c", str(ncycles)])
            sh(["iyokan_tpu.cli.packet_cli", "dec", "--key", self.skey,
                "--in", self.res, "--out", self.res])
            self._compare(self.res, out_file)

        self.add("tfhe-" + name, set(tags) | {"tfhe"}, fn, cost=cost)

    def add_in_out(self, name, blueprint, in_file, out_file, ncycles,
                   plain_ncycles=None, tfhe=True, plain_tags=(),
                   tfhe_tags=(), tfhe_cost=None):
        self.add_plain(name, blueprint, in_file, out_file,
                       ncycles=(-1 if plain_ncycles is None
                                else plain_ncycles), tags=plain_tags)
        if tfhe:
            # cost = rough encrypted work units (~bootstraps across the
            # run) used only for the deterministic cheap-first order
            self.add_tfhe(name, blueprint, in_file, out_file, ncycles,
                          tags=tfhe_tags,
                          cost=(tfhe_cost if tfhe_cost is not None
                                else float(max(ncycles, 1))))

    def select(self, tags):
        return [t for t in self.tests
                if all(tag in t["tags"] for tag in tags)]

    def run(self, tags, repeat, order="shuffle", retries=1, skip_ok=(),
            flush=None):
        sel = self.select(tags)
        print(f"[{len(sel)} TESTS SELECTED ({tags})] "
              + ", ".join(t["name"] for t in sel))
        failed = []
        self.results = []
        carried = [nm for nm in skip_ok
                   if any(t["name"] == nm for t in sel)]
        for nm in carried:
            print(f"Test {nm} SKIPPED (green in --resume-from record)")
            self.results.append({"name": nm, "ok": True, "seconds": 0.0,
                                 "resumed": True})
        if flush and carried:
            flush(failed)
        for it in range(repeat):
            if order == "cheap":
                # deterministic cheapest-first: a session window that dies
                # mid-run still banks the maximum number of green tests
                sel.sort(key=lambda t: (t["cost"], t["name"]))
            else:
                random.shuffle(sel)
            for t in sel:
                if t["name"] in carried:
                    continue
                start = time.time()
                ok = False
                # liveness heartbeat: encrypted MUX-memory tests run for
                # minutes with --quiet (compile + device cycles) and the
                # record otherwise goes silent
                hb_stop = threading.Event()

                def hb(name=t["name"], t0=start, ev=hb_stop):
                    while not ev.wait(180):
                        print(f"[hb] {name} still running "
                              f"({time.time() - t0:.0f}s)", flush=True)

                hb_thread = threading.Thread(target=hb, daemon=True)
                hb_thread.start()
                for attempt in range(1, retries + 1):
                    print(f"Test {t['name']} running"
                          + (f" (attempt {attempt}/{retries})"
                             if attempt > 1 else "") + "...", flush=True)
                    try:
                        t["fn"]()
                        print(f"Test {t['name']} done."
                              f" ({time.time() - start:.1f} sec.)")
                        ok = True
                        break
                    except Exception as e:  # noqa: BLE001
                        print(f"Test {t['name']} FAILED"
                              f" (attempt {attempt}/{retries}): {e}",
                              flush=True)
                hb_stop.set()
                if not ok:
                    failed.append(t["name"])
                self.results.append({
                    "name": t["name"], "ok": ok,
                    "seconds": round(time.time() - start, 2),
                })
                if flush:
                    flush(failed)
        return failed


def register(r: Runner):
    # the test.rb registry (tfhe counterparts for the short runs)
    import tomllib

    def blueprint_available(bp):
        path = r.fixture(bp)
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            cfg = tomllib.load(f)
        wd = os.path.dirname(path)
        return all(
            os.path.exists(os.path.join(wd, file["path"]))
            for file in cfg.get("file", [])
        )

    _add_in_out = r.add_in_out

    def guarded(name, bp, *a, **kw):
        if not blueprint_available(bp):
            print(f"(skipping {name}: fixture netlist missing from snapshot)")
            return
        _add_in_out(name, bp, *a, **kw)

    r.add_in_out = guarded
    # tfhe_cost = rough expected device seconds at cggi128 (round-3
    # records; ordering only, --order cheap)
    r.add_in_out("cahp-diamond-00", "config-toml/cahp-diamond.toml",
                 "in/test00.in", "out/test00-diamond.out", ncycles=8,
                 tfhe_cost=120)
    r.add_in_out("cahp-ruby-09", "config-toml/cahp-ruby.toml",
                 "in/test09.in", "out/test09-ruby.out", ncycles=7,
                 tfhe_cost=110)
    r.add_in_out("cahp-pearl-09", "config-toml/cahp-pearl.toml",
                 "in/test09.in", "out/test09-pearl.out", ncycles=3,
                 tfhe_cost=70)
    r.add_in_out("cahp-diamond-mux-00", "config-toml/cahp-diamond-mux.toml",
                 "in/test00.in", "out/test00-diamond.out", ncycles=8,
                 tfhe_cost=1900)
    r.add_in_out("cahp-ruby-mux-09", "config-toml/cahp-ruby-mux.toml",
                 "in/test09.in", "out/test09-ruby.out", ncycles=7,
                 tfhe_cost=1760)
    r.add_in_out("cahp-pearl-mux-09", "config-toml/cahp-pearl-mux.toml",
                 "in/test09.in", "out/test09-pearl.out", ncycles=3,
                 tfhe_cost=800)
    r.add_in_out("cahp-diamond-01", "config-toml/cahp-diamond.toml",
                 "in/test01.in", "out/test01-diamond.out", ncycles=346,
                 tfhe=False)
    r.add_in_out("cahp-ruby-10", "config-toml/cahp-ruby.toml",
                 "in/test10.in", "out/test10-ruby.out", ncycles=362,
                 tfhe=False)
    r.add_in_out("cahp-pearl-10", "config-toml/cahp-pearl.toml",
                 "in/test10.in", "out/test10-pearl.out", ncycles=264,
                 tfhe=False)
    # long MUX-memory variants (reference test.rb:414-419): the widest
    # plain workloads -- the 8808-cell MUX-RAM swept for hundreds of cycles
    r.add_in_out("cahp-diamond-mux-01", "config-toml/cahp-diamond-mux.toml",
                 "in/test01.in", "out/test01-diamond.out", ncycles=346,
                 tfhe=False)
    r.add_in_out("cahp-ruby-mux-10", "config-toml/cahp-ruby-mux.toml",
                 "in/test10.in", "out/test10-ruby.out", ncycles=362,
                 tfhe=False)
    r.add_in_out("cahp-pearl-mux-10", "config-toml/cahp-pearl-mux.toml",
                 "in/test10.in", "out/test10-pearl.out", ncycles=264,
                 tfhe=False)
    r.add_in_out("cahp-ruby-mux-1KiB-11", "config-toml/cahp-ruby-mux-1KiB.toml",
                 "in/test11.in", "out/test11.out", ncycles=7, tfhe=False)
    r.add_in_out("const-4bit-22", "config-toml/const-4bit.toml",
                 "in/test22.in", "out/test22.out", ncycles=1, plain_ncycles=1,
                 tfhe_tags=("tfhe-fast",), tfhe_cost=8)
    r.add_in_out("addr-4bit-04", "config-toml/addr-4bit.toml",
                 "in/test04.in", "out/test04.out", ncycles=1, plain_ncycles=1,
                 tfhe_tags=("tfhe-fast",), tfhe_cost=10)
    r.add_in_out("pass-addr-pass-4bit-04", "config-toml/pass-addr-pass-4bit.toml",
                 "in/test04.in", "out/test04.out", ncycles=1, plain_ncycles=1,
                 tfhe_cost=12)
    r.add_in_out("addr-register-4bit-16", "config-toml/addr-register-4bit.toml",
                 "in/test16.in", "out/test16.out", ncycles=3, plain_ncycles=3,
                 tfhe_tags=("tfhe-fast",), tfhe_cost=15)
    r.add_in_out("div-8bit-05", "config-toml/div-8bit.toml",
                 "in/test05.in", "out/test05.out", ncycles=1, plain_ncycles=1,
                 tfhe_cost=30)
    r.add_in_out("ram-addr8bit-06", "config-toml/ram-addr8bit.toml",
                 "in/test06.in", "out/test06.out", ncycles=16,
                 plain_ncycles=16, tfhe_cost=60)
    r.add_in_out("ram-addr9bit-07", "config-toml/ram-addr9bit.toml",
                 "in/test07.in", "out/test07.out", ncycles=16,
                 plain_ncycles=16, tfhe_cost=120)
    r.add_in_out("mux-ram-addr8bit-06", "config-toml/mux-ram-addr8bit.toml",
                 "in/test06.in", "out/test06.out", ncycles=16,
                 plain_ncycles=16, tfhe_cost=300)
    # tfhe-registered like the reference (test.rb:442-443): the widest
    # MUX-RAM workload under encryption (synthesized 9-bit-address RAM)
    r.add_in_out("mux-ram-addr9bit-07", "config-toml/mux-ram-addr9bit.toml",
                 "in/test07.in", "out/test07.out", ncycles=16,
                 plain_ncycles=16, tfhe_cost=900)
    r.add_in_out("ram-8-16-16-08", "config-toml/ram-8-16-16.toml",
                 "in/test08.in", "out/test08.out", ncycles=8, plain_ncycles=8,
                 tfhe_cost=60)
    r.add_in_out("mux-ram-8-16-16-08", "config-toml/mux-ram-8-16-16.toml",
                 "in/test08.in", "out/test08.out", ncycles=8, plain_ncycles=8,
                 tfhe_cost=150)
    r.add_in_out("rom-7-32-12", "config-toml/rom-7-32.toml",
                 "in/test12.in", "out/test12.out", ncycles=1, plain_ncycles=1,
                 tfhe_tags=("tfhe-fast",), tfhe_cost=15)
    r.add_in_out("rom-4-8-15", "config-toml/rom-4-8.toml",
                 "in/test15.in", "out/test15.out", ncycles=1, plain_ncycles=1,
                 tfhe_cost=12)
    r.add_in_out("counter-4bit-13", "config-toml/counter-4bit.toml",
                 "in/test13.in", "out/test13.out", ncycles=3, plain_ncycles=3,
                 tfhe_tags=("tfhe-fast",), tfhe_cost=12)
    r.add_in_out("cahp-ruby-14", "config-toml/cahp-ruby.toml",
                 "in/test14.in", "out/test14.out", ncycles=20,
                 plain_ncycles=20, tfhe=False)
    r.add_in_out("cahp-ruby-iyokanl1-09", "config-toml/cahp-ruby-iyokanl1.toml",
                 "in/test09.in", "out/test09-ruby.out", ncycles=-1,
                 tfhe=False)
    r.add_in_out("dff-reset-23", "config-toml/dff-reset.toml",
                 "in/test23.in", "out/test23.out", ncycles=1, plain_ncycles=1,
                 tfhe_tags=("tfhe-fast",))
    r.add_in_out("big-mult-21", "config-toml/big-mult.toml",
                 "in/test21.in", "out/test21.out", ncycles=1, plain_ncycles=1,
                 tfhe=False)

    # --dump-prefix content assertions (reference test.rb:474-485)
    def check_dump7(dump_prefix):
        import tomllib

        from iyokan_tpu import packet as pm

        pkt = pm.PlainPacket.load(dump_prefix + "-7")
        toml = tomllib.loads(pkt.to_toml())
        assert int(toml["cycles"]) == 7, toml["cycles"]
        bits = toml["bits"]
        assert {"bytes": [0], "size": 1, "name": "finflag"} in bits, bits
        assert {"bytes": [42, 0], "size": 16, "name": "reg_x0"} in bits, bits

    def plain_dump_prefix():
        dump = os.path.join(r.wd, "_dump")
        sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
            "--in", r.fixture("in/test00.in"), "--out", r.req])
        sh(["iyokan_tpu.cli.iyokan_cli", "plain", "--quiet",
            "--blueprint", r.fixture("config-toml/cahp-diamond.toml"),
            "-i", r.req, "-o", r.res, "-c", "8", "--dump-prefix", dump])
        check_dump7(dump)
        r._compare(r.res, "out/test00-diamond.out")

    def tfhe_dump_prefix():
        r.ensure_keys()
        dump = os.path.join(r.wd, "_dump")
        sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
            "--in", r.fixture("in/test00.in"), "--out", r.req])
        sh(["iyokan_tpu.cli.packet_cli", "enc", "--key", r.skey,
            "--in", r.req, "--out", r.req])
        sh(["iyokan_tpu.cli.iyokan_cli", "tfhe", "--quiet",
            "--blueprint", r.fixture("config-toml/cahp-diamond.toml"),
            "--evalkey", r.bkey, "--secret-key", r.skey,
            "-i", r.req, "-o", r.res, "-c", "8", "--dump-prefix", dump])
        check_dump7(dump)
        sh(["iyokan_tpu.cli.packet_cli", "dec", "--key", r.skey,
            "--in", r.res, "--out", r.res])
        r._compare(r.res, "out/test00-diamond.out")

    r.add("plain-cahp-diamond-dump-prefix-00", {"plain", "fast"},
          plain_dump_prefix)
    r.add("tfhe-cahp-diamond-dump-prefix-00", {"tfhe"}, tfhe_dump_prefix,
          cost=120)

    # chained runs: result packet -> convert -> next run's request
    # (reference test.rb:487-545)
    def plain_chained():
        sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
            "--in", r.fixture("in/test20.in"), "--out", r.req])
        sh(["iyokan_tpu.cli.iyokan_cli", "plain", "--quiet",
            "--blueprint", r.fixture("config-toml/addr-4bit.toml"),
            "-i", r.req, "-o", r.res, "-c", "1"])
        sh(["iyokan_tpu.cli.packet_cli", "convert-plain",
            "-o", r.req, "-i", "a", r.res, "--",
            "bits.A = a.out", "bits.B = a.out"])
        sh(["iyokan_tpu.cli.iyokan_cli", "plain", "--quiet",
            "--blueprint", r.fixture("config-toml/addr-4bit.toml"),
            "-i", r.req, "-o", r.res, "-c", "1"])
        r._compare(r.res, "out/test20.out")

    def tfhe_chained():
        r.ensure_keys()
        sh(["iyokan_tpu.cli.packet_cli", "toml2packet",
            "--in", r.fixture("in/test20.in"), "--out", r.req])
        sh(["iyokan_tpu.cli.packet_cli", "enc", "--key", r.skey,
            "--in", r.req, "--out", r.req])
        sh(["iyokan_tpu.cli.iyokan_cli", "tfhe", "--quiet",
            "--blueprint", r.fixture("config-toml/addr-4bit.toml"),
            "--evalkey", r.bkey, "-i", r.req, "-o", r.res, "-c", "1"])
        sh(["iyokan_tpu.cli.packet_cli", "convert",
            "-o", r.req, "-i", "a", r.res, "--",
            "bits.A = a.out", "bits.B = a.out"])
        sh(["iyokan_tpu.cli.iyokan_cli", "tfhe", "--quiet",
            "--blueprint", r.fixture("config-toml/addr-4bit.toml"),
            "--evalkey", r.bkey, "-i", r.req, "-o", r.res, "-c", "1"])
        sh(["iyokan_tpu.cli.packet_cli", "dec", "--key", r.skey,
            "--in", r.res, "--out", r.res])
        r._compare(r.res, "out/test20.out")

    r.add("plain-addr-addr-4bit-20", {"plain", "fast"}, plain_chained)
    r.add("tfhe-addr-addr-4bit-20", {"tfhe", "tfhe-fast"}, tfhe_chained,
          cost=25)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tags", nargs="*", default=[])
    ap.add_argument("--params", default="cggi128")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--results-json", default=None,
                    help="write a machine-readable run record (selected "
                         "tests, per-test seconds, failures, platform); "
                         "flushed after every test")
    ap.add_argument("--order", default="shuffle",
                    choices=("shuffle", "cheap"),
                    help="run order (cheap = deterministic cheapest-first, "
                         "for device runs bounded by a session window)")
    ap.add_argument("--retries", type=int, default=1,
                    help="attempts per test")
    ap.add_argument("--resume-from", default=None,
                    help="previous --results-json: skip tests green there")
    args = ap.parse_args()

    # registry runs are compile-dominated (16 distinct circuits, few
    # cycles each): per-level dispatch shares the bucketed bootstrap
    # graphs across levels and circuits, while level-group fusion would
    # compile a distinct graph per circuit's group signature.  An
    # explicit env still wins.
    os.environ.setdefault("IYOKAN_FUSE_LEVELS", "1")

    wd = args.workdir or tempfile.mkdtemp(prefix="iyokan-tests-")
    os.makedirs(wd, exist_ok=True)
    r = Runner(wd, args.params)
    register(r)

    import json

    import jax

    skip_ok = []
    if args.resume_from and os.path.exists(args.resume_from):
        with open(args.resume_from) as f:
            prev = json.load(f)
        if prev.get("params") == args.params:
            skip_ok = [t["name"] for t in prev.get("tests", [])
                       if t.get("ok")]
        else:
            print(f"(ignoring --resume-from: params "
                  f"{prev.get('params')} != {args.params})")

    def flush(failed):
        if not args.results_json:
            return
        with open(args.results_json + ".tmp", "w") as f:
            json.dump({
                "tags": args.tags,
                "params": args.params,
                "platform": jax.devices()[0].platform,
                "fuse_levels": os.environ.get("IYOKAN_FUSE_LEVELS"),
                "repeat": args.repeat,
                "order": args.order,
                "retries": args.retries,
                "selected": len(r.select(args.tags)),
                "failed": failed,
                "tests": r.results,
            }, f, indent=1)
        os.replace(args.results_json + ".tmp", args.results_json)

    failed = r.run(args.tags, args.repeat, order=args.order,
                   retries=args.retries, skip_ok=skip_ok, flush=flush)
    flush(failed)
    if args.results_json:
        print(f"wrote {args.results_json}")
    if failed:
        print("FAILED:", ", ".join(failed))
        sys.exit(1)
    print("ALL PASSED")


if __name__ == "__main__":
    main()
