"""Toeplitz-slab external product / blind rotation (ops.slab_extprod).

The tkey form computes the negacyclic convolution against the key as int8
GEMMs on precomputed Toeplitz windows, exact mod 2^32: with all 4 limbs and
the symmetric gadget the blind rotation is bit-identical to the NTT route;
the 3-limb, lb=2 default is checked at the decrypt level.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iyokan_tpu import gates
from iyokan_tpu.crypto import host, ops
from iyokan_tpu.crypto import polymul as pm


def _conv_ref(d: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Negacyclic convolution sum_j d_j (*) key_j,u mod 2^32 (numpy)."""
    G, RR, N = d.shape
    out = np.zeros((G, 2, N), np.uint64)
    for j in range(RR):
        for u in range(2):
            for k in range(N):
                row = d[:, j, k].astype(np.int64)
                shifted = np.roll(key[j, u].astype(np.int64), k)
                shifted[:k] = -shifted[:k]
                out[:, u, :] += (row[:, None] * shifted).astype(np.uint64)
    return (out & 0xFFFFFFFF).astype(np.uint32)


def test_tkey_slab_matmul_exact_4limb(toy, rng):
    """Slab path == direct negacyclic convolution, bit-exact at 4 limbs."""
    p = toy
    RR = 2 * p.l
    key = rng.integers(0, 1 << 32, (1, RR, 2, p.N), dtype=np.uint32)
    slabs = pm.tkey_prep1(key, p, limbs=4)[0]
    d = rng.integers(-p.Bg // 2, p.Bg // 2, (4, RR, p.N)).astype(np.int32)
    got = pm.tkey_extprod_ref(d, slabs, 4)
    want = _conv_ref(d, key[0])
    np.testing.assert_array_equal(got, want)


def test_tkey_truncation_small(toy, rng):
    """3-limb truncation error is bounded by the dropped limb's scale."""
    p = toy
    RR = 2 * p.l
    key = rng.integers(0, 1 << 32, (1, RR, 2, p.N), dtype=np.uint32)
    d = rng.integers(-p.Bg // 2, p.Bg // 2, (4, RR, p.N)).astype(np.int32)
    exact = pm.tkey_extprod_ref(d, pm.tkey_prep1(key, p, limbs=4)[0], 4)
    trunc = pm.tkey_extprod_ref(d, pm.tkey_prep1(key, p, limbs=3)[0], 3)
    err = (exact.astype(np.int64) - trunc.astype(np.int64)) % (1 << 32)
    err = np.where(err >= 1 << 31, err - (1 << 32), err)
    # |sum of RR*N products of |d|<=Bg/2 by a dropped limb| <= RR*N*Bg/2*128
    bound = RR * p.N * (p.Bg // 2) * 128
    assert np.abs(err).max() <= bound


@pytest.mark.parametrize("limbs", [3, 4])
@pytest.mark.parametrize("lb", [1, 2, 3])
def test_slab_step_matches_reference(toy, rng, lb, limbs):
    """One XLA slab step (digits of a random diff, window GEMM, limb
    recombination) is bit-identical to the numpy reference of the same
    slab, for every asymmetric gadget depth and limb count."""
    p = toy
    key = rng.integers(0, 1 << 32, (1, 2 * p.l, 2, p.N), dtype=np.uint32)
    slab = pm.tkey_kernel_key(key, p, limbs, lb=lb)
    assert slab.shape == (1, (p.l + lb) * p.N, 2 * limbs * 128)
    diff = rng.integers(0, 1 << 32, (8, 2, p.N), dtype=np.uint32)
    got = np.asarray(jax.jit(lambda d, s: ops.slab_extprod(d, s, p))(
        jnp.asarray(diff), jnp.asarray(slab[0])))
    digits = np.concatenate(
        [np.asarray(ops.gadget_digits(jnp.asarray(diff[:, 0]), p.l, p)),
         np.asarray(ops.gadget_digits(jnp.asarray(diff[:, 1]), lb, p))],
        axis=1)
    rows = np.concatenate([key[:, : p.l], key[:, p.l : p.l + lb]], axis=1)
    want = pm.tkey_extprod_ref(digits, pm.tkey_prep1(rows, p, limbs)[0],
                               limbs)
    np.testing.assert_array_equal(got, want)


def test_tkey_blind_rotate_bitexact_4limb(toy, toy_ek, toy_dk_ntt, toy_sk,
                                          rng):
    """4-limb symmetric slab blind rotation is bit-identical to the NTT
    route."""
    p = toy
    bits = rng.integers(0, 2, 8, dtype=np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))
    testv = jnp.full((p.N,), jnp.uint32(p.mu))

    bk_tk = jnp.asarray(pm.tkey_kernel_key(toy_ek.bk, p, limbs=4))
    got = np.asarray(ops.blind_rotate(ct, bk_tk, testv, p))
    want = np.asarray(ops.blind_rotate(ct, toy_dk_ntt.bkntt, testv, p,
                                       toy_dk_ntt.backend))
    np.testing.assert_array_equal(got, want)


def test_tkey_blind_rotate_fat_layout(toy, rng):
    """Slab rows are ordered (128-lane block, digit row j, lane), columns
    (part u, limb, lane): the kernel key is the reordered Toeplitz slab of
    tkey_prep1."""
    p = toy
    lb, L = 2, 3
    key = rng.integers(0, 1 << 32, (2, 2 * p.l, 2, p.N), dtype=np.uint32)
    slab = pm.tkey_kernel_key(key, p, L, lb=lb)
    rows = np.concatenate([key[:, : p.l], key[:, p.l : p.l + lb]], axis=1)
    prep = pm.tkey_prep1(rows, p, L)            # [n, RR, 2, L, N, 128]
    RR = p.l + lb
    for (i, b, j, t, u, li) in [(0, 0, 0, 0, 0, 0), (1, 1, 3, 77, 1, 2),
                                (0, p.N // 128 - 1, RR - 1, 127, 1, 0)]:
        row = (b * RR + j) * 128 + t
        np.testing.assert_array_equal(
            slab[i, row, (u * L + li) * 128:(u * L + li + 1) * 128],
            prep[i, j, u, li, 128 * b + t])


def test_stale_unquantized_key_warns(toy, toy_sk, monkeypatch):
    """An eval key with full-torus masks (pre-quantization snapshot or
    IYOKAN_BK_MASK_BITS=32) triggers a warning when prepared for the
    truncated slab: such keys ride it with ~2^-6 phase noise."""
    monkeypatch.setenv("IYOKAN_BK_MASK_BITS", "32")
    ek = host.genevalkey(toy_sk, seed=7, with_cb=False)
    assert np.any(ek.bk[:, :, 0, :] & 0xFF)     # masks really unquantized
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    with pytest.warns(UserWarning, match="unquantized"):
        ops.DeviceKeys.from_evalkey(ek, with_cb=False)


def test_quantized_key_no_warning(toy, toy_ek, monkeypatch, recwarn):
    """Default keygen (256-grid masks) prepares for the slab without the
    stale-key warning."""
    assert not np.any(toy_ek.bk[:, :, 0, :] & 0xFF)
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    assert not [w for w in recwarn if "unquantized" in str(w.message)]


def test_tkey_gate_bootstrap_truth_tables(toy, toy_sk, toy_dk, toy_ek, rng):
    """3-limb default: NAND/XOR truth tables through the slab route."""
    p = toy
    combos = [(0, 0), (0, 1), (1, 0), (1, 1)]
    kinds = [gates.NAND, gates.XOR]
    rows_a, rows_b, cas, cbs, ks = [], [], [], [], []
    for kind in kinds:
        ca, cb, k = gates.GATE_LIN[kind]
        for (a, b) in combos:
            rows_a.append(a); rows_b.append(b)
            cas.append(ca); cbs.append(cb); ks.append(k)
    A = jnp.asarray(host.encrypt_bits(toy_sk, np.array(rows_a), rng))
    B = jnp.asarray(host.encrypt_bits(toy_sk, np.array(rows_b), rng))

    pre = ops.gate_linear(A, B, jnp.asarray(cas, jnp.int32),
                          jnp.asarray(cbs, jnp.int32),
                          jnp.asarray(ks, jnp.int32), p)
    testv = jnp.full((p.N,), jnp.uint32(p.mu))
    bk_tk = jnp.asarray(pm.tkey_kernel_key(toy_ek.bk, p, limbs=3))
    acc = ops.blind_rotate(pre, bk_tk, testv, p)
    t1 = ops.sample_extract(acc, 0)
    out = ops.keyswitch_10(t1, toy_dk.ksk_mat, p)

    ph = host.tlwe0_phase(toy_sk, np.asarray(out))
    got = (ph < (1 << 31)).astype(int)
    plain = {
        gates.NAND: lambda a, b: 1 - (a & b),
        gates.XOR: lambda a, b: a ^ b,
    }
    i = 0
    for kind in kinds:
        for (a, b) in combos:
            want = plain[kind](a, b)
            assert got[i] == want, (
                f"{gates.NAMES[kind]}({a},{b}) = {got[i]}, want {want}"
            )
            i += 1


def test_tkey_asymmetric_gadget_gates(toy, toy_sk, toy_ek, rng):
    """lb=2 asymmetric slab (5 contraction rows instead of 6): the b-part
    decomposition error enters the phase directly (~2^-9.7 sigma at
    cggi128), so decrypted gate results stay correct."""
    p = toy
    bk_tk = jnp.asarray(pm.tkey_kernel_key(toy_ek.bk, p, 4, lb=2))
    assert bk_tk.shape[1] == (p.l + 2) * p.N
    a = np.array([0, 0, 1, 1] * 4, np.uint8)
    b = np.array([0, 1, 0, 1] * 4, np.uint8)
    A = jnp.asarray(host.encrypt_bits(toy_sk, a, rng))
    B = jnp.asarray(host.encrypt_bits(toy_sk, b, rng))
    ca, cb, kk = gates.GATE_LIN[gates.NAND]
    pre = ops.gate_linear(A, B, jnp.full((16,), ca, jnp.int32),
                          jnp.full((16,), cb, jnp.int32),
                          jnp.full((16,), kk, jnp.int32), p)
    testv = jnp.full((p.N,), np.uint32(p.mu))
    tr = ops.blind_rotate(pre, bk_tk, testv, p)
    ph = host.trlwe1_phase(toy_sk, np.asarray(tr))[:, 0]
    got = (np.asarray(ph) < (1 << 31)).astype(np.uint8)
    np.testing.assert_array_equal(got, 1 - (a & b))


def test_tkey_awkward_batch_sizes(toy, toy_ek, toy_dk_ntt, toy_sk, rng):
    """Any batch size (odd ones, and the engine's nb + 2*nm bucket sums
    96, 192) rides the slab route unpadded, bit-exact at 4 limbs."""
    p = toy
    bk = jnp.asarray(pm.tkey_kernel_key(toy_ek.bk, p, limbs=4))
    testv = jnp.full((p.N,), jnp.uint32(p.mu))
    for G in (5, 24, 96, 192):
        bits = rng.integers(0, 2, G, dtype=np.uint8)
        ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))
        want = np.asarray(ops.blind_rotate(ct, toy_dk_ntt.bkntt, testv, p,
                                           toy_dk_ntt.backend))
        got = np.asarray(ops.blind_rotate(ct, bk, testv, p))
        np.testing.assert_array_equal(got, want, err_msg=f"G={G}")


def test_tkey_slab_disk_cache_roundtrip(toy, toy_ek, tmp_path, monkeypatch):
    """The opt-in on-disk slab cache returns the identical expansion.

    Processes that share a key can skip the host Toeplitz expansion
    (ops._slab_disk_path); the cache must be keyed so a second build in a
    clean in-process LRU loads the same bytes from disk."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", str(tmp_path))
    monkeypatch.setattr(ops, "_DEVICE_KEY_CACHE", type(
        ops._DEVICE_KEY_CACHE)())
    k1 = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    files = [f for f in os.listdir(tmp_path) if f.startswith("tkslab-")]
    assert len(files) == 1 and files[0].endswith(".npy")
    ops._DEVICE_KEY_CACHE.clear()
    k2 = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    np.testing.assert_array_equal(np.asarray(k1.bkntt), np.asarray(k2.bkntt))
    # a corrupt cache file must fall back to a fresh build, not crash
    with open(os.path.join(tmp_path, files[0]), "wb") as f:
        f.write(b"not an npy")
    ops._DEVICE_KEY_CACHE.clear()
    k3 = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    np.testing.assert_array_equal(np.asarray(k1.bkntt), np.asarray(k3.bkntt))


def test_gpu_platform_routes_to_slab(toy, toy_sk, toy_ek, rng, monkeypatch):
    """With JAX reporting a GPU, the engine's default keys take the
    matrix-unit polynomial backend and the XLA slab route for gate
    bootstraps, and nothing imports a Pallas kernel."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("IYOKAN_BR_IMPL", raising=False)
    monkeypatch.delenv("IYOKAN_POLY_BACKEND", raising=False)
    monkeypatch.setattr(ops, "_DEVICE_KEY_CACHE", type(
        ops._DEVICE_KEY_CACHE)())
    assert pm.get_backend().name == "mxu"
    dk = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    assert dk.backend.name == "mxu"
    assert dk.bkntt.dtype == jnp.int8          # the slab, not an NTT prep
    assert dk.ksk_mat.dtype == jnp.int8        # int8 limb key switch
    a = np.array([0, 0, 1, 1], np.uint8)
    b = np.array([0, 1, 0, 1], np.uint8)
    A = jnp.asarray(host.encrypt_bits(toy_sk, a, rng))
    B = jnp.asarray(host.encrypt_bits(toy_sk, b, rng))
    ca, cb, kk = gates.GATE_LIN[gates.NAND]
    pre = ops.gate_linear(A, B, jnp.full((4,), ca, jnp.int32),
                          jnp.full((4,), cb, jnp.int32),
                          jnp.full((4,), kk, jnp.int32), toy)
    t1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_for(4), toy, dk.backend)
    out = ops.keyswitch_10(t1, dk.ksk_mat, toy)
    np.testing.assert_array_equal(
        host.decrypt_bits(toy_sk, np.asarray(out)), 1 - (a & b))
    assert not [m for m in sys.modules
                if m.startswith(("iyokan_tpu.ops", "jax.experimental.pallas"))]


def test_unknown_platform_raises(monkeypatch):
    """A platform without a polynomial backend is an error, not a
    silent default."""
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    monkeypatch.delenv("IYOKAN_POLY_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="no polynomial backend"):
        pm.get_backend()


def test_unknown_br_impl_raises(toy_ek, monkeypatch):
    """Blind-rotation routes that no longer exist are refused by name."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "pallas")
    with pytest.raises(ValueError, match="IYOKAN_BR_IMPL"):
        ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
