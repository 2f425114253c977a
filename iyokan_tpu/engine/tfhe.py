"""TFHE levelized executor.

Encrypted counterpart of engine.plain: node values are TLWE lvl0 samples
(u32 [num_nodes, n+1]), and each level becomes

  gather -> linear combine -> ONE batched blind rotation over all 2-input
  gates and both MUX half-gates -> sample extract -> (MUX pair combine at
  lvl1) -> one batched key switch -> scatter,

replacing the reference's per-gate TFHEpp tasks on a thread pool
(reference src/iyokan_tfhepp.hpp:109-146).  NOT gates are free torus
negations; copies are gathers.

Built-in CMUX memories follow the reference dataflow exactly
(reference src/iyokan_tfhepp.hpp:675-889):
  ROM read:  CB addr bits -> inter-word CMUX tree (inverted TRGSW) ->
             intra-word rotate ladder -> per-bit sample extract -> KS.
  RAM read:  CB addr bits -> CMUX tree over 2^a words per bit -> SEI(0) -> KS.
  RAM write: MUXwoSE(wren ? wdata : rdata) -> per-address CMUX chain ->
             SEI(0)+KS -> batched gate-bootstrap refresh of all words.
"""

from __future__ import annotations

import os
import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .. import gates as G
from ..circuit.compile import Compiled
from ..crypto import host, ops
from ..crypto.ops import u32
from ..parallel.mesh import (get_mesh, replicate_on_mesh, replicated,
                             shard_batch)

I32 = jnp.int32

class TFHEEngine:
    def __init__(self, compiled: Compiled, eval_key: host.EvalKey):
        self.c = compiled
        self.d = compiled.design
        self.p = eval_key.params
        needs_cb = bool(self.d.rom_insts or self.d.ram_insts)
        if needs_cb and eval_key.bk2.shape[0] == 0:
            # reference: CMUX memories require the circuit(-bootstrapping)
            # key (needsCircuitKey, src/iyokan.hpp:1897-1906)
            raise ValueError(
                "blueprint uses CMUX ROM/RAM but the eval key has no "
                "circuit-bootstrapping material (generate with with_cb=True)"
            )
        # under an active mesh the keys are built whole on every device
        self.keys = ops.DeviceKeys.from_evalkey(eval_key, with_cb=needs_cb)
        self._tick = jax.jit(self._tick_impl)
        # jitted entry points take the keys as arguments (pytree), never as
        # closure constants -- see DeviceKeys.  Under a mesh the state
        # (wire values, memory stores) is made whole on every device and
        # every jitted call returns it with that same sharding, so no
        # program compiles a second time for a new input sharding.
        #
        # The combinational sweep is one jitted call *per level* (or per
        # fused group of levels), with the batch padded to a power-of-two
        # bucket: the expensive blind-rotate graph then compiles once per
        # bucket size and is reused across levels and cycles.  The whole
        # cycle can instead be traced as ONE call
        # (IYOKAN_FUSE_LEVELS=all, _cycle_fn): that
        # instantiates a separate rotation loop per level group in the
        # HLO -- a one-time compile-size cost -- but drops the per-cycle
        # dispatch count to one.
        self._level_fns = {}
        self._mem_fns = {}
        self._padded_plans = [self._pad_plan(pl_) for pl_ in compiled.levels]

    # ------------------------------------------------------------------ #
    @staticmethod
    def _bucket(n: int) -> int:
        if n == 0:
            return 0
        b = 16
        while b < n:
            b *= 2
        return b

    def _pad_plan(self, plan):
        """Pad a level's gather/scatter arrays to bucket sizes.

        Dummy rows gather node 0 and scatter into the scratch slot
        (index num_nodes) appended to the value array.
        """
        dump = self.c.num_nodes
        nb, nm = len(plan.bin_out), len(plan.mux_out)
        nbb, nmb = self._bucket(nb), self._bucket(nm)

        def pad(arr, size, fill):
            out = np.full(size, fill, np.int32)
            out[: len(arr)] = arr
            return out

        ca = np.array([G.GATE_LIN[k][0] for k in plan.bin_kind], np.int32)
        cb = np.array([G.GATE_LIN[k][1] for k in plan.bin_kind], np.int32)
        kk = np.array([G.GATE_LIN[k][2] for k in plan.bin_kind], np.int32)
        return {
            "nb": nbb, "nm": nmb,
            "bin_a": pad(plan.bin_a, nbb, 0),
            "bin_b": pad(plan.bin_b, nbb, 0),
            "ca": pad(ca, nbb, 1), "cb": pad(cb, nbb, 1),
            "kk": pad(kk, nbb, 0),
            "bin_out": pad(plan.bin_out, nbb, dump),
            "mux_a": pad(plan.mux_a, nmb, 0),
            "mux_b": pad(plan.mux_b, nmb, 0),
            "mux_s": pad(plan.mux_s, nmb, 0),
            "mux_out": pad(plan.mux_out, nmb, dump),
            "not_src": plan.not_src, "not_out": plan.not_out,
            "copy_src": plan.copy_src, "copy_out": plan.copy_out,
        }

    def _chunked_bootstrap(self, keys, batch):
        """Bootstrap a level batch as power-of-two chunks of at most
        IYOKAN_BOOT_CHUNK rows (default 2048) per device, each chunk
        sharded over the gates axis of an active mesh (shard_batch).

        Bucketed level sizes are nb_bucket + 2*nm_bucket, so wide
        MUX-memory circuits produce batches like 4128 or 8192.  Power-of-
        two chunks keep the set of blind-rotation shapes small, so compiled
        programs are shared across levels and circuits, and cap the
        per-chunk working set (the stacked slab windows are 8*G*(l+lb)*N
        bytes per step).  Bucket sizes decompose exactly: 4128 ->
        2048+2048+32, 8192 -> 4x2048.  The cap was first chosen on another
        accelerator; the GPU's own choice is open.
        IYOKAN_BOOT_CHUNK=0 restores single-dispatch batches."""
        p = self.p
        total = batch.shape[0]
        cap = int(os.environ.get("IYOKAN_BOOT_CHUNK", "2048"))
        mesh = get_mesh()
        if mesh is not None:
            cap *= mesh.devices.size
        if cap <= 0 or total <= 16:
            return ops.gate_bootstrap_tlwe1(shard_batch(batch),
                                            keys.bk_for(total),
                                            p, keys.backend)
        outs, i = [], 0
        while i < total:
            c = 1 << (min(cap, total - i).bit_length() - 1)
            outs.append(ops.gate_bootstrap_tlwe1(
                shard_batch(batch[i : i + c]), keys.bk_for(c), p,
                keys.backend))
            i += c
        if len(outs) == 1:
            return outs[0]
        return jnp.concatenate(outs, axis=0)

    def _level_body(self, nb, nm, keys, vals, ba, bb, ca, cb, kk, bo,
                    ma, mb, ms, mo):
        """One level's gather -> batched bootstrap -> scatter (traced)."""
        p = self.p
        mu = u32(p.mu)
        vals = replicated(vals)
        pres = []
        if nb:
            A = vals[ba]
            B = vals[bb]
            pres.append(ops.gate_linear(A, B, ca, cb, kk, p))
        if nm:
            Av = vals[ma]
            Bv = vals[mb]
            S = vals[ms]
            pre1 = (S + Bv).at[:, p.n].add(u32(0) - mu)
            pre2 = (Av - S).at[:, p.n].add(u32(0) - mu)
            pres.extend([pre1, pre2])
        t1 = self._chunked_bootstrap(keys, jnp.concatenate(pres, axis=0))
        rows = []
        if nb:
            rows.append(t1[:nb])
        if nm:
            comb = t1[nb : nb + nm] + t1[nb + nm :]
            comb = comb.at[:, p.N].add(mu)
            rows.append(comb)
        lvl1 = jnp.concatenate(rows, axis=0)
        out = ops.keyswitch_10(lvl1, keys.ksk_mat, p)
        ids = jnp.concatenate([bo, mo])
        return replicated(vals.at[ids].set(out))

    def _level_fn(self, nb: int, nm: int):
        key = (nb, nm)
        if key not in self._level_fns:
            fn = jax.jit(functools.partial(self._level_body, nb, nm))
            self._level_fns[key] = fn
        return self._level_fns[key]

    # -- multi-level fusion: one jitted call per GROUP of consecutive
    # gate-only levels.  Each dispatch has a fixed host cost; fusing k
    # levels divides the per-cycle call count by k while the compiled
    # graphs still cache on the group signature, which is stable across
    # cycles.  Levels with memory ops (ROM/RAM) end their group.
    _LEVEL_ARGS = ("bin_a", "bin_b", "ca", "cb", "kk", "bin_out",
                   "mux_a", "mux_b", "mux_s", "mux_out")

    def _group_fn(self, sig):
        key = ("group", sig)
        if key not in self._level_fns:

            def fn(keys, vals, *flat):
                i = 0
                for (nb, nm, nnot, ncopy) in sig:
                    if nb or nm:
                        args = flat[i : i + 10]
                        i += 10
                        vals = self._level_body(nb, nm, keys, vals, *args)
                    if nnot or ncopy:
                        ns, no, cs, co = flat[i : i + 4]
                        i += 4
                        vals = vals.at[no].set(u32(0) - vals[ns])
                        vals = vals.at[co].set(vals[cs])
                return replicated(vals)

            self._level_fns[key] = jax.jit(fn)
        return self._level_fns[key]

    def _group_plans(self, max_group: int):
        """Partition levels into fusable groups (cached).

        Returns a list of entries: ("group", sig, flat_args, n_gates) for
        fused gate/simple levels, or ("mem", plan) for levels that touch a
        ROM/RAM (run per-instance as before).
        """
        if getattr(self, "_groups", None) is not None:
            return self._groups
        groups = []
        cur_sig, cur_flat, cur_gates = [], [], 0

        def flush():
            nonlocal cur_sig, cur_flat, cur_gates
            if cur_sig:
                groups.append(("group", tuple(cur_sig), tuple(cur_flat),
                               cur_gates))
            cur_sig, cur_flat, cur_gates = [], [], 0

        dump = self.c.num_nodes
        for plan, pp in zip(self.c.levels, self._padded_plans):
            nnot, ncopy = len(pp["not_out"]), len(pp["copy_out"])
            sig = (pp["nb"], pp["nm"],
                   self._bucket(max(nnot, 1)) if nnot else 0,
                   self._bucket(max(ncopy, 1)) if ncopy else 0)
            if pp["nb"] or pp["nm"] or nnot or ncopy:
                if sig[0] or sig[1]:
                    cur_flat.extend(pp[k] for k in self._LEVEL_ARGS)
                if sig[2] or sig[3]:
                    b = max(sig[2], sig[3])

                    def pad_io(src, out):
                        s = np.zeros(b, np.int32)
                        o = np.full(b, dump, np.int32)
                        s[: len(src)] = src
                        o[: len(out)] = out
                        return s, o

                    ns, no = pad_io(pp["not_src"], pp["not_out"])
                    cs, co = pad_io(pp["copy_src"], pp["copy_out"])
                    cur_flat.extend([ns, no, cs, co])
                    sig = (sig[0], sig[1], b, b)
                cur_sig.append(sig)
                cur_gates += plan.n_gates
            if plan.rom_reads or plan.ram_reads:
                flush()
                groups.append(("mem", plan))
            elif len(cur_sig) >= max_group:
                flush()
        flush()
        self._groups = groups
        return groups

    def _sweep_body(self, groups, ram_names, keys, vals, rams, roms,
                    refresh=True):
        """The traced combinational sweep + RAM write shared by the
        single-trace execution modes (_cycle_fn, _scan_fn): level groups,
        per-level memory reads (shared CB, ROM/RAM trees), then the fused
        RAM write.  Returns (vals, ram_outs_tuple).  settle's eager
        group-fused path keeps its own loop so the RAM write stays behind
        its jitted wrapper (_ram_write_fn).

        refresh may be a Python bool (baked into the trace) or a traced
        scalar bool (the scan path's per-cycle periodic-refresh flag,
        lowered to lax.cond -- both branches return identical shapes)."""
        ram_sel: Dict[str, jnp.ndarray] = {}
        for entry in groups:
            if entry[0] == "group":
                _, sig, flat, _n = entry
                vals = self._group_fn(sig)(keys, vals, *flat)
            else:
                vals = self._mem_level(keys, vals, rams, roms,
                                       entry[1], ram_sel)
        if ram_names:
            stores = tuple(rams[n] for n in ram_names)
            sels = tuple(ram_sel[n] for n in ram_names)
            if isinstance(refresh, bool):
                outs = self._ram_write_all(ram_names, keys, vals, stores,
                                           sels, refresh=refresh)
            else:
                outs = jax.lax.cond(
                    refresh,
                    lambda: self._ram_write_all(ram_names, keys, vals,
                                                stores, sels, refresh=True),
                    lambda: self._ram_write_all(ram_names, keys, vals,
                                                stores, sels, refresh=False),
                )
        else:
            outs = ()
        return vals, outs

    def _cycle_fn(self, ram_names: tuple, rom_names: tuple):
        """ONE jitted call for the entire combinational sweep + RAM write.

        Inlines every level group, the per-level memory reads (shared CB,
        ROM/RAM trees) and the fused RAM write into a single traced
        function of (keys, vals, ram_stores, rom_stores).  Each level
        group's rotation loop becomes its own instance in the HLO, so the
        one-time compile is larger; per cycle the runtime sees a single
        dispatch."""
        key = ("cycle", ram_names, rom_names)
        if key not in self._mem_fns:
            # grouping granularity is irrelevant inside one trace (any
            # cached partition works); maximal groups if none cached yet
            groups = self._group_plans(10**9)

            def fn(keys, vals, ram_vals, rom_vals, refresh):
                return self._sweep_body(
                    groups, ram_names, keys, vals,
                    dict(zip(ram_names, ram_vals)),
                    dict(zip(rom_names, rom_vals)),
                    refresh=refresh,
                )

            self._mem_fns[key] = jax.jit(fn, static_argnums=(4,))
        return self._mem_fns[key]

    def _scan_fn(self, ram_names: tuple, rom_names: tuple, in_nodes: tuple):
        """jitted lax.scan over whole cycles (see run_cycles)."""
        key = ("scan", ram_names, rom_names, in_nodes)
        if key not in self._mem_fns:
            groups = self._group_plans(10**9)
            idx = (np.asarray(in_nodes, np.int32) if in_nodes else None)

            def fn(keys, vals, ram_vals, rom_vals, in_rows, refresh_flags):
                roms = dict(zip(rom_names, rom_vals))

                def body(carry, xs):
                    rows, refresh = xs
                    vals, ram_vals = carry
                    vals = self._tick_impl(vals)
                    if idx is not None:
                        vals = vals.at[idx].set(rows)
                    vals, outs = self._sweep_body(
                        groups, ram_names, keys, vals,
                        dict(zip(ram_names, ram_vals)), roms,
                        refresh=(refresh if ram_names else True),
                    )
                    return (vals, outs), None

                (vals, ram_vals), _ = jax.lax.scan(
                    body, (vals, ram_vals), (in_rows, refresh_flags)
                )
                return vals, ram_vals

            self._mem_fns[key] = jax.jit(fn)
        return self._mem_fns[key]

    def run_cycles(self, vals, rams, roms, in_nodes, in_rows,
                   refresh_flags=None):
        """Run k = len(in_rows) full cycles (tick -> input scatter ->
        combinational sweep -> RAM write) as ONE dispatch via lax.scan.

        The scan body is the same traced cycle as _cycle_fn, so the
        compiled size is one cycle regardless of k; the per-cycle host
        round-trip disappears entirely (the reference's frontend loops on
        the host per cycle, src/iyokan_plain.cpp:270-292 -- here the whole
        multi-cycle run is a single device program).

        in_nodes: node ids receiving circular inputs each cycle;
        in_rows: u32 [k, len(in_nodes), n+1] ciphertext rows;
        refresh_flags: optional bool [k], the driver's periodic RAM
        refresh schedule (None = refresh every cycle).
        """
        ram_names = tuple(sorted(rams))
        rom_names = tuple(sorted(roms))
        k = len(in_rows)
        if refresh_flags is None:
            flags = jnp.ones((k,), jnp.bool_)
        else:
            flags = jnp.asarray(np.asarray(refresh_flags, np.bool_))
        fn = self._scan_fn(ram_names, rom_names, tuple(in_nodes))
        vals, ram_vals = fn(
            self.keys, vals,
            tuple(rams[n] for n in ram_names),
            tuple(roms[n] for n in rom_names),
            jnp.asarray(np.asarray(in_rows, np.uint32)),
            flags,
        )
        return vals, dict(zip(ram_names, ram_vals))

    def _simple_fn(self):
        """NOT gates + copies of a level (cheap, one shared jit)."""
        if "simple" not in self._level_fns:

            @jax.jit
            def fn(vals, not_src, not_out, copy_src, copy_out):
                vals = vals.at[not_out].set(u32(0) - vals[not_src])
                return replicated(vals.at[copy_out].set(vals[copy_src]))

            self._level_fns["simple"] = fn
        return self._level_fns["simple"]

    # ------------------------------------------------------------------ #
    # state constructors / accessors
    # ------------------------------------------------------------------ #
    def init_vals(self) -> jnp.ndarray:
        # one extra scratch row (index num_nodes) absorbs padded scatters
        p = self.p
        vals = jnp.zeros((self.c.num_nodes + 1, p.n + 1), u32)
        # everything starts as trivial 0 (reference DFF/const init,
        # src/iyokan_tfhepp.hpp:18-58); constants get their trivial value
        neg_mu = u32(0) - u32(p.mu)
        vals = vals.at[:, p.n].set(neg_mu)
        if len(self.c.const_nodes):
            cv = np.where(
                self.c.const_vals.astype(bool), np.uint32(p.mu),
                (~(np.uint32(p.mu)) + np.uint32(1)),
            )
            vals = vals.at[self.c.const_nodes, p.n].set(jnp.asarray(cv))
        return replicate_on_mesh(vals)

    def set_nodes(self, vals, nodes, cts) -> jnp.ndarray:
        """Scatter externally supplied ciphertexts into node slots."""
        idx = np.asarray(nodes, np.int32)
        return replicate_on_mesh(
            vals.at[idx].set(jnp.asarray(np.asarray(cts, np.uint32))))

    def set_const_bits(self, vals, nodes, bits) -> jnp.ndarray:
        ct = host.trivial_tlwe0(self.p, np.asarray(bits, np.uint8))
        return self.set_nodes(vals, nodes, ct)

    def read_nodes(self, vals, nodes) -> np.ndarray:
        # device-side gather + one transfer (not a per-node host loop):
        # required shape for the 64K+-node workloads (BASELINE.md config 5)
        idx = np.array([0 if n is None else n for n in nodes], np.int32)
        out = np.asarray(vals[jnp.asarray(idx)]).copy()
        missing = np.array([n is None for n in nodes], bool)
        if missing.any():
            out[missing] = host.trivial_tlwe0(self.p, np.zeros(1, np.uint8))[0]
        return out

    def make_rom_store(self, name, addr_width, data_width, data):
        inst = self.d.rom_insts[name]
        p = self.p
        assert data_width & (data_width - 1) == 0, (
            "CMUX ROM data width must be a power of two"
        )
        total_bits = (1 << addr_width) * data_width
        n_tr = max(1, -(-total_bits // p.N))
        if data is None:
            store = np.zeros((n_tr, 2, p.N), np.uint32)
            store[:, 1, :] = (~(np.uint32(p.mu)) + np.uint32(1))  # all bits 0
        else:
            store = np.asarray(data, np.uint32)
            if store.shape[0] != n_tr:
                raise ValueError("invalid request packet: wrong length of ROM")
        return replicate_on_mesh(jnp.asarray(store))

    def make_ram_store(self, name, addr_width, data_width, data):
        p = self.p
        if data is None:
            store = np.zeros(((1 << addr_width), data_width, 2, p.N),
                             np.uint32)
            store[..., 1, 0] = (~(np.uint32(p.mu)) + np.uint32(1))
        else:
            data = np.asarray(data, np.uint32)
            if data.shape[0] != (1 << addr_width) * data_width:
                raise ValueError("invalid request packet: wrong length of RAM")
            store = data.reshape((1 << addr_width), data_width, 2, p.N)
        return replicate_on_mesh(jnp.asarray(store))

    def read_ram_store(self, store) -> np.ndarray:
        a, w = store.shape[0], store.shape[1]
        return np.asarray(store).reshape(a * w, 2, store.shape[-1])

    def block_until_ready(self, vals):
        jax.block_until_ready(vals)

    # ------------------------------------------------------------------ #
    def _tick_impl(self, vals):
        if len(self.c.tick_dst) == 0:
            return vals
        return replicated(
            vals.at[self.c.tick_dst].set(vals[self.c.tick_src]))

    def tick(self, vals):
        return self._tick(vals)

    # ------------------------------------------------------------------ #
    # the per-cycle combinational sweep
    # ------------------------------------------------------------------ #
    def _cb_pairs(self, keys, vals, addr_nodes):
        """CBWithInv of address wires -> prepared TRGSW selectors.

        Returns backend-prepared rows [a, 2(normal/inv), 2l, 2, K, N].
        """
        p = self.p
        tl = vals[np.asarray(addr_nodes, np.int32)]
        trgsw = ops.circuit_bootstrap(tl, keys.bk2_for(),
                                      keys.pksk_mats, p, keys.backend)
        inv = ops.trgsw_invert(trgsw, p)
        both = jnp.stack([trgsw, inv], axis=1)       # [a, 2, 2l, 2, N]
        return replicated(ops.prep_trgsw(both, p, keys.backend))

    def _cb_fn(self, nodes: tuple):
        """One jitted CB batch for ALL memory instances of a level: the
        635-step lvl2 rotation is latency-bound at these widths (7-23
        rows), so per-instance loops would each pay the full depth."""
        key = ("cb", nodes)
        if key not in self._mem_fns:
            arr = np.asarray(nodes, np.int32)
            self._mem_fns[key] = jax.jit(
                lambda keys, vals: self._cb_pairs(keys, vals, arr)
            )
        return self._mem_fns[key]

    def _mem_level(self, keys, vals, rams, roms, plan, ram_sel, mark=None):
        """Run all ROM/RAM reads of one level: a single batched CB over
        every instance's address bits, then the per-instance trees."""
        mems = ([("rom", nm) for nm in plan.rom_reads]
                + [("ram", nm) for nm in plan.ram_reads])
        nodes, spans = [], []
        for kind, nm in mems:
            inst = (self.d.rom_insts if kind == "rom"
                    else self.d.ram_insts)[nm]
            spans.append((kind, nm, len(nodes),
                          len(nodes) + len(inst.addr_nodes)))
            nodes.extend(inst.addr_nodes)
        gn_all = self._cb_fn(tuple(nodes))(keys, vals)
        if mark is not None:
            mark(f"cb x{len(nodes)}", "cb")
        for kind, nm, lo, hi in spans:
            gn = gn_all[lo:hi]
            if kind == "rom":
                vals = self._mem_fn("rom", nm)(keys, vals, roms[nm], gn)
                if mark is not None:
                    mark(f"rom {nm}", "rom_read")
            else:
                vals = self._mem_fn("ram_read", nm)(keys, vals, rams[nm], gn)
                ram_sel[nm] = gn
                if mark is not None:
                    mark(f"ram-read {nm}", "ram_read")
        return vals

    def _rom_read(self, keys, vals, rom_store, gn, name):
        """Reference TaskTFHEppROMUX: UROMUX inter-word CMUX tree then LROMUX
        intra-word rotate ladder (src/iyokan_tfhepp.hpp:238-338).

        gn: prepared CBWithInv selectors for this instance's address bits
        (sliced from the level's shared CB batch, see _mem_level)."""
        p = self.p
        inst = self.d.rom_insts[name]
        a, w = inst.addr_width, inst.data_width
        log2w = w.bit_length() - 1
        log2wpt = p.logN - log2w                     # words per TRLWE
        n_inter = max(0, a - log2wpt)

        be = keys.backend
        words = rom_store                            # [2^n_inter, 2, N]
        for b in range(n_inter):
            g = gn[log2wpt + b, 1]                   # inverted: bit==0 -> even
            words = ops.cmux(g, words[0::2], words[1::2], p, be)
        acc = words[0]                               # [2, N]

        for bit in range(1, log2wpt + 1):
            if log2wpt - bit >= a:
                continue
            shift = (2 * p.N) - (p.N >> bit)
            g = gn[log2wpt - bit, 0]                 # normal
            rot = ops.rot_poly(acc, jnp.full((2,), shift, I32), p.N)
            acc = acc + ops.extprod_term(g, rot - acc, p, be)

        lvl1 = jnp.stack([ops.sample_extract(acc, b) for b in range(w)])
        out = ops.keyswitch_10(lvl1, keys.ksk_mat, p)
        return replicated(
            vals.at[np.asarray(inst.read_nodes, np.int32)].set(out))

    def _ram_read(self, keys, vals, ram_store, gn, name):
        """Reference TaskTFHEppRAMUX (src/iyokan_tfhepp.hpp:409-498):
        CMUX tree over 2^a words per data bit, inverted selectors.

        gn: prepared selectors from the level's shared CB (_mem_level)."""
        p = self.p
        inst = self.d.ram_insts[name]
        words = ram_store                            # [2^a, w, 2, N]
        for b in range(inst.addr_width):
            g = gn[b, 1]                             # inverted
            words = ops.cmux(g, words[0::2], words[1::2], p,
                             keys.backend)
        acc = words[0]                               # [w, 2, N]
        lvl1 = ops.sample_extract(acc, 0)            # [w, N+1]
        out = ops.keyswitch_10(lvl1, keys.ksk_mat, p)
        return replicated(
            vals.at[np.asarray(inst.read_nodes, np.int32)].set(out))

    def _ram_write_all(self, names, keys, vals, stores, gns, refresh=True):
        """All RAM instances' write paths in one traced call: one MUXwoSE
        blind rotate, per-instance CMUX chains, then (refresh=True) ONE
        fused SEI -> KS -> refresh bootstrap over the concatenated
        (2^a * w) words of every instance -- the refresh is the widest
        batch of the cycle, and splitting it per instance would run the
        635-step rotation twice.

        refresh=False (periodic-refresh cycles, IYOKAN_RAM_REFRESH_PERIOD):
        the full-store refresh is the single most expensive stage of a
        cycle (~2^a*w rows of gate bootstrap: 4096 rows on cahp-diamond,
        about as many as ALL of the cycle's gates) but its only job is
        noise control -- the CMUX-tree output IS a valid TRLWE store.  Per
        skipped cycle every word gains only the write-tree noise
        a * var_extprod ~= 8 * 2^-27.2 = 2^-24.2 (l=3/Bg=64: key term
        2*l*N*(Bg/2)^2*alpha1^2 + decomp (1+N)*eps^2), ~85x below the
        standing word noise, so a period-P schedule adds P * 2^-24.2 --
        at P=16 a negligible 2^-20.2 against the 2^-17.8 refreshed-word
        floor.  The freshly *written* rows would dominate instead (sum of
        two rotation outputs = 2x variance): they get their own W-row
        refresh bootstrap here (W=16 on diamond -- 256x fewer rows than
        the full-store refresh it replaces).  See test_noise_and_params
        for the budget regression and PERF.md for the measured effect.
        """
        p = self.p
        mu = u32(p.mu)
        testv = jnp.full((p.N,), mu)

        insts = [self.d.ram_insts[nm] for nm in names]
        pres1, pres2 = [], []
        for inst in insts:
            wren = vals[inst.wren_node]              # [n+1]
            wdata = vals[np.asarray(inst.wdata_nodes, np.int32)]
            rdata = vals[np.asarray(inst.rdata_out_nodes, np.int32)]
            pres1.append((wren[None, :] + wdata).at[:, p.n].add(u32(0) - mu))
            pres2.append((rdata - wren[None, :]).at[:, p.n].add(u32(0) - mu))
        ws = [inst.data_width for inst in insts]
        W = sum(ws)
        tr = ops.blind_rotate(jnp.concatenate(pres1 + pres2),
                              keys.bk_for(2 * W), testv, p, keys.backend)
        written_all = tr[:W] + tr[W:]
        written_all = written_all.at[:, 1, 0].add(mu)    # [W, 2, N]
        if not refresh:
            # refresh just the W written rows so the store's standing noise
            # stays at the refreshed-word floor (see docstring)
            lv1 = ops.sample_extract(written_all, 0)     # [W, N+1]
            tl0 = ops.keyswitch_10(lv1, keys.ksk_mat, p)
            written_all = ops.blind_rotate(tl0, keys.bk_for(W), testv,
                                           p, keys.backend)

        lvl1_rows, shapes, accs = [], [], []
        off = 0
        for inst, store, gn, w in zip(insts, stores, gns, ws):
            a = inst.addr_width
            written = written_all[off:off + w]
            off += w

            addrs = np.arange(1 << a)
            acc = jnp.broadcast_to(written[None], (1 << a, w, 2, p.N))
            for j in range(a):
                sel = ((addrs >> j) & 1).astype(np.int32)  # 1 -> normal(0)
                pol = np.where(sel == 1, 0, 1)
                g = gn[j][pol]                       # [2^a, 2l, 2, K, N]
                g = g[:, None]                       # broadcast over w
                acc = ops.cmux(g, acc, store, p, keys.backend)
            if not refresh:
                accs.append(acc)
                continue
            lvl1_rows.append(
                ops.sample_extract(acc, 0).reshape((1 << a) * w, p.N + 1)
            )
            shapes.append((1 << a, w))
        if not refresh:
            return tuple(replicated(a) for a in accs)

        flat = shard_batch(jnp.concatenate(lvl1_rows))
        tlwe0 = ops.keyswitch_10(flat, keys.ksk_mat, p)
        fresh = ops.blind_rotate(tlwe0, keys.bk_for(flat.shape[0]), testv,
                                 p, keys.backend)
        outs, off = [], 0
        for (A, w) in shapes:
            outs.append(
                replicated(fresh[off:off + A * w].reshape(A, w, 2, p.N)))
            off += A * w
        return tuple(outs)

    def _ram_write_fn(self, names: tuple, refresh: bool = True):
        key = ("ram_write_all", names, refresh)
        if key not in self._mem_fns:
            self._mem_fns[key] = jax.jit(
                functools.partial(self._ram_write_all, names,
                                  refresh=refresh)
            )
        return self._mem_fns[key]

    # ------------------------------------------------------------------ #
    def _mem_fn(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._mem_fns:
            if kind == "rom":
                fn = jax.jit(functools.partial(self._rom_read, name=name))
            else:
                fn = jax.jit(functools.partial(self._ram_read, name=name))
            self._mem_fns[key] = fn
        return self._mem_fns[key]

    def settle(self, vals, rams, roms, timer=None, progress=None,
               stages=None, ram_refresh=True):
        """Host-driven sweep: one jitted call per level (bucketed shapes)
        plus per-instance memory calls.

        timer: optional list collecting per-level wall-clock seconds (forces
        a device sync per level, opt-in like the reference's
        ProgressGraphMaker).  progress: optional callable(n_gates_done).
        stages: optional dict accumulating wall-clock seconds per stage
        category (gates / simple / rom_read / ram_read / ram_write) -- the
        per-cycle breakdown tools/run_diamond_tfhe.py reports.
        """
        import os
        import time

        profile = bool(os.environ.get("IYOKAN_PROFILE"))
        sync = profile or timer is not None or stages is not None

        def mark(tag, cat=None):
            if sync:
                jax.block_until_ready(vals)
                now = time.time()
                dt = now - mark.t0
                mark.t0 = now
                if profile and dt > 0.005:
                    print(f"    [profile] {tag}: {dt*1e3:.0f} ms", flush=True)
                if stages is not None and cat is not None:
                    stages[cat] = stages.get(cat, 0.0) + dt
                return dt
            return 0.0

        mark.t0 = time.time()
        keys = self.keys
        ram_sel: Dict[str, jnp.ndarray] = {}

        fuse_env = os.environ.get("IYOKAN_FUSE_LEVELS", "8")
        if fuse_env == "all" and not sync and progress is None:
            # whole-cycle fusion: one dispatch for sweep + RAM write
            ram_names = tuple(sorted(rams))
            rom_names = tuple(sorted(roms))
            vals, outs = self._cycle_fn(ram_names, rom_names)(
                keys, vals,
                tuple(rams[n] for n in ram_names),
                tuple(roms[n] for n in rom_names),
                bool(ram_refresh),
            )
            return vals, dict(zip(ram_names, outs))
        fuse = 8 if fuse_env == "all" else int(fuse_env)
        if not sync and progress is None and fuse > 1:
            # fused fast path: one dispatch per group of gate-only levels
            for entry in self._group_plans(fuse):
                if entry[0] == "group":
                    _, sig, flat, _n = entry
                    vals = self._group_fn(sig)(keys, vals, *flat)
                    continue
                vals = self._mem_level(keys, vals, rams, roms, entry[1],
                                       ram_sel)
            new_rams = {}
            if rams:
                names = tuple(sorted(rams))
                outs = self._ram_write_fn(names, bool(ram_refresh))(
                    keys, vals,
                    tuple(rams[n] for n in names),
                    tuple(ram_sel[n] for n in names),
                )
                new_rams = dict(zip(names, outs))
            return vals, new_rams

        for lv, (plan, pp) in enumerate(
            zip(self.c.levels, self._padded_plans)
        ):
            lv_t = 0.0
            if pp["nb"] or pp["nm"]:
                fn = self._level_fn(pp["nb"], pp["nm"])
                vals = fn(
                    keys, vals,
                    pp["bin_a"], pp["bin_b"], pp["ca"], pp["cb"], pp["kk"],
                    pp["bin_out"], pp["mux_a"], pp["mux_b"], pp["mux_s"],
                    pp["mux_out"],
                )
                lv_t += mark(f"level {lv+1} gates ({pp['nb']}+{pp['nm']}mux)", "gates")
            if len(pp["not_out"]) or len(pp["copy_out"]):
                vals = self._simple(vals, pp)
                lv_t += mark(f"level {lv+1} simple", "simple")
            if plan.rom_reads or plan.ram_reads:
                mem_t = []

                def mem_mark(tag, cat, lv=lv):
                    mem_t.append(mark(f"level {lv+1} {tag}", cat))

                vals = self._mem_level(keys, vals, rams, roms, plan,
                                       ram_sel, mark=mem_mark)
                lv_t += sum(mem_t)
            if timer is not None:
                timer.append(lv_t)
            if progress is not None:
                progress(plan.n_gates)

        new_rams = {}
        if rams:
            names = tuple(sorted(rams))
            outs = self._ram_write_fn(names, bool(ram_refresh))(
                keys, vals,
                tuple(rams[n] for n in names),
                tuple(ram_sel[n] for n in names),
            )
            new_rams = dict(zip(names, outs))
            if sync:
                jax.block_until_ready(outs)
            mark(f"ram-write x{len(names)}", "ram_write")
        return vals, new_rams

    def _simple(self, vals, pp):
        """NOT + copy rows, padded to shared buckets."""
        dump = self.c.num_nodes

        def padded(src, out):
            b = self._bucket(max(len(src), 1))
            s = np.zeros(b, np.int32)
            o = np.full(b, dump, np.int32)
            s[: len(src)] = src
            o[: len(out)] = out
            return s, o

        ns, no = padded(pp["not_src"], pp["not_out"])
        cs, co = padded(pp["copy_src"], pp["copy_out"])
        return self._simple_fn()(vals, ns, no, cs, co)
