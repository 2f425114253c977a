import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iyokan_tpu import gates
from iyokan_tpu.crypto import host, ops


def _dec_bits(sk, ct):
    return host.decrypt_bits(sk, np.asarray(ct))


def test_extprod_cmux_select(toy, toy_sk, rng):
    """CMUX with a fresh TRGSW selects between two TRLWE messages."""
    mu = np.uint32(toy.mu)
    m0 = np.zeros(toy.N, np.uint32)
    m1 = np.zeros(toy.N, np.uint32)
    m0[0] = mu
    m1[0] = np.uint32(0) - mu
    c0 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m0, toy.alpha1, rng))
    c1 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m1, toy.alpha1, rng))
    for sel in (0, 1):
        g = jnp.asarray(host.trgsw1_encrypt(toy_sk, sel, rng))
        g_ntt = jax.jit(lambda g: ops.prep_trgsw(g, toy))(g)
        out = jax.jit(lambda gn, a, b: ops.cmux(gn, a, b, toy))(g_ntt, c1, c0)
        ph = host.trlwe1_phase(toy_sk, np.asarray(out))
        got = 1 if ph[0] < 1 << 31 else 0
        want = 1 if (m1[0] if sel else m0[0]) < 1 << 31 else 0
        assert got == want, f"sel={sel}"


def test_trgsw_invert(toy, toy_sk, rng):
    mu = np.uint32(toy.mu)
    m0 = np.zeros(toy.N, np.uint32); m0[0] = mu
    m1 = np.zeros(toy.N, np.uint32); m1[0] = np.uint32(0) - mu
    c0 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m0, toy.alpha1, rng))
    c1 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m1, toy.alpha1, rng))
    g = jnp.asarray(host.trgsw1_encrypt(toy_sk, 1, rng))
    ginv = ops.trgsw_invert(g, toy)  # encrypts 0
    g_ntt = jax.jit(lambda g: ops.prep_trgsw(g, toy))(ginv)
    out = jax.jit(lambda gn, a, b: ops.cmux(gn, a, b, toy))(g_ntt, c1, c0)
    ph = host.trlwe1_phase(toy_sk, np.asarray(out))
    assert (ph[0] < 1 << 31)  # selected c0 (message +mu -> bit 1)


def test_gate_bootstrap_truth_tables(toy, toy_sk, toy_dk, rng):
    """All 8 linear 2-input gates, all 4 input combos, in one batch."""
    p = toy
    kinds = list(gates.GATE_LIN)
    combos = [(0, 0), (0, 1), (1, 0), (1, 1)]
    rows_a, rows_b, cas, cbs, ks = [], [], [], [], []
    for kind in kinds:
        ca, cb, k = gates.GATE_LIN[kind]
        for (a, b) in combos:
            rows_a.append(a); rows_b.append(b)
            cas.append(ca); cbs.append(cb); ks.append(k)
    A = jnp.asarray(host.encrypt_bits(toy_sk, np.array(rows_a), rng))
    B = jnp.asarray(host.encrypt_bits(toy_sk, np.array(rows_b), rng))

    @jax.jit
    def run(A, B, ca, cb, k):
        pre = ops.gate_linear(A, B, ca, cb, k, p)
        t1 = ops.gate_bootstrap_tlwe1(pre, toy_dk.bkntt, p)
        return ops.keyswitch_10(t1, toy_dk.ksk_mat, p)

    out = run(A, B, jnp.asarray(cas, jnp.int32), jnp.asarray(cbs, jnp.int32),
              jnp.asarray(ks, jnp.int32))
    got = _dec_bits(toy_sk, out)

    plain = {
        gates.AND: lambda a, b: a & b,
        gates.NAND: lambda a, b: 1 - (a & b),
        gates.ANDNOT: lambda a, b: a & (1 - b),
        gates.OR: lambda a, b: a | b,
        gates.NOR: lambda a, b: 1 - (a | b),
        gates.ORNOT: lambda a, b: a | (1 - b),
        gates.XOR: lambda a, b: a ^ b,
        gates.XNOR: lambda a, b: 1 - (a ^ b),
    }
    i = 0
    for kind in kinds:
        for (a, b) in combos:
            want = plain[kind](a, b)
            assert got[i] == want, (
                f"{gates.NAMES[kind]}({a},{b}) = {got[i]}, want {want}"
            )
            i += 1


def test_hom_mux(toy, toy_sk, toy_dk, rng):
    """MUX via two bootstraps + lvl1 combine (reference HomMUX shape)."""
    p = toy
    cases = [(a, b, s) for a in (0, 1) for b in (0, 1) for s in (0, 1)]
    A = jnp.asarray(host.encrypt_bits(toy_sk, np.array([c[0] for c in cases]), rng))
    B = jnp.asarray(host.encrypt_bits(toy_sk, np.array([c[1] for c in cases]), rng))
    S = jnp.asarray(host.encrypt_bits(toy_sk, np.array([c[2] for c in cases]), rng))

    @jax.jit
    def run(A, B, S):
        mu = jnp.uint32(p.mu)
        # t1 = AND(s, b), t2 = ANDNOT-style AND(not s, a)
        pre1 = (S + B).at[:, p.n].add(jnp.uint32(0) - mu)
        pre2 = (A - S).at[:, p.n].add(jnp.uint32(0) - mu)
        both = jnp.concatenate([pre1, pre2], axis=0)
        t = ops.gate_bootstrap_tlwe1(both, toy_dk.bkntt, p)
        G = A.shape[0]
        comb = t[:G] + t[G:]
        comb = comb.at[:, p.N].add(mu)
        return ops.keyswitch_10(comb, toy_dk.ksk_mat, p)

    got = _dec_bits(toy_sk, run(A, B, S))
    for i, (a, b, s) in enumerate(cases):
        want = b if s else a
        assert got[i] == want, f"MUX(a={a},b={b},s={s}) -> {got[i]}"


def test_hom_not_and_trivial(toy, toy_sk, rng):
    bits = np.array([0, 1, 0, 1], np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))
    got = _dec_bits(toy_sk, ops.hom_not(ct))
    np.testing.assert_array_equal(got, 1 - bits)


@pytest.mark.slow
def test_circuit_bootstrap_cmux(toy, toy_sk, toy_dk, rng):
    """CB output TRGSW drives a correct CMUX (both polarities)."""
    p = toy
    bits = np.array([0, 1], np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))

    @jax.jit
    def cb(ct):
        return ops.circuit_bootstrap(ct, toy_dk.bk2ntt, toy_dk.pksk_mats, p)

    trgsw = cb(ct)  # [2, 2l, 2, N]
    mu = np.uint32(p.mu)
    m0 = np.zeros(p.N, np.uint32); m0[0] = mu            # bit 1
    m1 = np.zeros(p.N, np.uint32); m1[0] = np.uint32(0) - mu  # bit 0
    c0 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m0, p.alpha1, rng))
    c1 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m1, p.alpha1, rng))

    for i, m in enumerate(bits):
        g_ntt = jax.jit(lambda g: ops.prep_trgsw(g, p))(trgsw[i])
        out = jax.jit(lambda gn, a, b: ops.cmux(gn, a, b, p))(g_ntt, c1, c0)
        ph = host.trlwe1_phase(toy_sk, np.asarray(out))
        got = 1 if ph[0] < 1 << 31 else 0
        want = 0 if m else 1  # m selects c1 (bit 0), else c0 (bit 1)
        assert got == want, f"CB bit {m}"
        # also check the inverted TRGSW
        ginv_ntt = jax.jit(lambda g: ops.prep_trgsw(g, p))(
            ops.trgsw_invert(trgsw[i], p)
        )
        out = jax.jit(lambda gn, a, b: ops.cmux(gn, a, b, p))(ginv_ntt, c1, c0)
        ph = host.trlwe1_phase(toy_sk, np.asarray(out))
        got = 1 if ph[0] < 1 << 31 else 0
        assert got == (0 if (1 - m) else 1), f"CBInv bit {m}"


@pytest.mark.slow
def test_circuit_bootstrap_unrolled_key(toy, toy_sk, toy_dk, rng):
    """The 2-bit unrolled CB key (bk2u, half sequential depth) drives the
    same CMUX selections as the plain bk2 path."""
    p = toy
    assert toy_dk.bk2untt is not None
    assert toy_dk.bk2_for() is toy_dk.bk2untt
    bits = np.array([0, 1], np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))

    @jax.jit
    def cb(ct):
        return ops.circuit_bootstrap(ct, toy_dk.bk2untt, toy_dk.pksk_mats, p)

    trgsw = cb(ct)
    mu = np.uint32(p.mu)
    m0 = np.zeros(p.N, np.uint32); m0[0] = mu                 # bit 1
    m1 = np.zeros(p.N, np.uint32); m1[0] = np.uint32(0) - mu  # bit 0
    c0 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m0, p.alpha1, rng))
    c1 = jnp.asarray(host.trlwe1_encrypt(toy_sk, m1, p.alpha1, rng))
    for i, m in enumerate(bits):
        g_ntt = jax.jit(lambda g: ops.prep_trgsw(g, p))(trgsw[i])
        out = jax.jit(lambda gn, a, b: ops.cmux(gn, a, b, p))(g_ntt, c1, c0)
        ph = host.trlwe1_phase(toy_sk, np.asarray(out))
        got = 1 if ph[0] < 1 << 31 else 0
        assert got == (0 if m else 1), f"CB(bk2u) bit {m}"


def test_devicekeys_small_batch_routing(toy, toy_ek, monkeypatch):
    """The slab route (default) serves every batch size and builds no
    unrolled NTT key; the NTT route routes batches of <= 256 rows to its
    2-bit unrolled key."""
    p = toy
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_TKEY_LIMBS", "4")

    dk = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    _, lb = ops.tkey_default_config(p)
    assert dk.bkntt.dtype == jnp.int8
    assert dk.bkntt.shape == (p.n, (p.l + lb) * p.N, 2 * 4 * 128)
    assert dk.bkuntt is None
    for g in (16, 64, 256, 2048):
        assert dk.bk_for(g) is dk.bkntt

    monkeypatch.setenv("IYOKAN_BR_IMPL", "ntt")
    dk4 = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    assert dk4.bkntt.dtype != jnp.int8
    assert dk4.bkuntt is not None
    assert dk4.bk_for(64) is dk4.bkuntt
    assert dk4.bk_for(256) is dk4.bkuntt
    assert dk4.bk_for(257) is dk4.bkntt
    assert dk4.bk_for(1024) is dk4.bkntt


def test_keyswitch_i8_limb_path_bitexact(toy, toy_sk, toy_ek, toy_dk, rng):
    """The int8 balanced-limb key-switch (the GPU's int8 GEMM path) is
    bit-identical to the u32 bf16-limb path, for both the identity KS
    and the private functional KS."""
    import jax.numpy as jnp

    p = toy
    bits = rng.integers(0, 2, 8, dtype=np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))
    testv = jnp.full((p.N,), jnp.uint32(p.mu))
    tr = ops.blind_rotate(ct, toy_dk.bkntt, testv, p, toy_dk.backend)
    t1 = ops.sample_extract(tr, 0)

    ksk_u32 = np.asarray(toy_ek.ksk.reshape(p.N * p.ks_t, p.n + 1))
    ksk_i8 = ops.key_i8_limbs(ksk_u32)
    # limbs reconstruct the key exactly mod 2^32
    rec = sum(ksk_i8[j].astype(np.int64) << (8 * j) for j in range(4))
    np.testing.assert_array_equal((rec & 0xFFFFFFFF).astype(np.uint32),
                                  ksk_u32)
    a = np.asarray(ops.keyswitch_10(t1, jnp.asarray(ksk_u32), p))
    b = np.asarray(ops.keyswitch_10(t1, jnp.asarray(ksk_i8), p))
    np.testing.assert_array_equal(a, b)

    # private functional KS (circuit bootstrap path)
    mus = np.uint64(1 << 62)
    tl2 = jnp.asarray(
        rng.integers(0, 1 << 63, (4, p.N2 + 1), dtype=np.uint64) + mus)
    pk_u32 = np.asarray(toy_ek.pksk[0].reshape(p.N2 * p.pks_t, 2 * p.N))
    a2 = np.asarray(ops.privks(tl2, jnp.asarray(pk_u32), 0, p))
    b2 = np.asarray(ops.privks(tl2, jnp.asarray(ops.key_i8_limbs(pk_u32)),
                               0, p))
    np.testing.assert_array_equal(a2, b2)
