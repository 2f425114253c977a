"""Noise-budget statistics and alternate parameter sets (slow tier).

The reference's encrypted tests assert on decrypted outputs; here we
additionally measure the phase-noise distribution of freshly bootstrapped
gates against the documented budget (params.py) -- the engine analogue of
TFHEpp's parameter-fidelity requirements (SURVEY.md section 7 hard part f).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iyokan_tpu import gates, params as params_mod
from iyokan_tpu.crypto import host, ops


def _bootstrap_nand(p, sk, ek, G, seed):
    keys = ops.DeviceKeys.from_evalkey(ek, with_cb=False)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = jnp.asarray(host.encrypt_bits(sk, a, rng))
    B = jnp.asarray(host.encrypt_bits(sk, b, rng))
    ca, cb, kk = gates.GATE_LIN[gates.NAND]

    @jax.jit
    def run(keys, A, B):
        pre = ops.gate_linear(
            A, B, jnp.full((G,), ca, jnp.int32),
            jnp.full((G,), cb, jnp.int32), jnp.full((G,), kk, jnp.int32), p,
        )
        t1 = ops.gate_bootstrap_tlwe1(pre, keys.bkntt, p, keys.backend)
        return ops.keyswitch_10(t1, keys.ksk_mat, p)

    out = np.asarray(run(keys, A, B))
    want = 1 - (a & b)
    return out, want


@pytest.mark.slow
def test_noise_margin_toy(toy, toy_sk, toy_ek):
    """Phase error of bootstrapped gates stays far below the 1/16 threshold."""
    out, want = _bootstrap_nand(toy, toy_sk, toy_ek, 256, 11)
    got = host.decrypt_bits(toy_sk, out)
    np.testing.assert_array_equal(got, want)

    phase = host.tlwe0_phase(toy_sk, out).astype(np.int64)
    mu = toy.mu
    signed = np.where(phase > 1 << 31, phase - (1 << 32), phase)
    err = np.where(want == 1, signed - mu, signed + mu)
    sigma = err.std() / 2.0 ** 32
    # toy params: practically noiseless; 1/16 threshold with huge margin
    assert sigma < 1 / 64, f"sigma = {sigma}"


@pytest.mark.slow
def test_cggi128_gates():
    """Full 128-bit parameters: batched NAND correct, noise within budget."""
    p = params_mod.CGGI128
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    out, want = _bootstrap_nand(p, sk, ek, 64, 12)
    got = host.decrypt_bits(sk, out)
    np.testing.assert_array_equal(got, want)

    phase = host.tlwe0_phase(sk, out).astype(np.int64)
    signed = np.where(phase > 1 << 31, phase - (1 << 32), phase)
    err = np.where(want == 1, signed - p.mu, signed + p.mu)
    sigma = err.std() / 2.0 ** 32
    # documented budget (params.py noise sketch): sigma ~= 2^-8.2.  Assert
    # with ~1.4x headroom so a regression that doubles the variance fails
    # here, not only in a 100k-gate device run (tools/measure_error_rate.py
    # writes the repeatable JSON record of such a run).
    assert sigma < 2.0 ** -7.7, f"sigma = {sigma} (budget ~2^-8.2)"


@pytest.mark.slow
def test_cggi128_device_default_kernel_noise(monkeypatch):
    """Noise regression for the default blind-rotation config.

    The engine default is the Toeplitz slab, whose limb truncation adds
    noise on top of the bootstrap noise (~2^-10.6 sigma at L=3 against the
    ~2^-8.8 bootstrap sigma).  This runs the full NAND bootstrap through
    the *same config resolution* the engine uses on device
    (ops.tkey_default_config: IYOKAN_TKEY_LIMBS / IYOKAN_TK_LB defaults)
    on CPU, and asserts the combined bootstrap + truncation +
    keyswitch sigma against the same documented budget as the XLA path
    (sigma ~= 2^-8.2, asserted at 2^-7.7 = ~1.4x headroom): a future
    config flip that eats the margin fails here, not in a 100k-gate
    device run (tools/measure_error_rate.py)."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    p = params_mod.CGGI128
    L, lb = ops.tkey_default_config(p)
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    out, want = _bootstrap_nand(p, sk, ek, 64, 17)
    got = host.decrypt_bits(sk, out)
    np.testing.assert_array_equal(got, want)

    phase = host.tlwe0_phase(sk, out).astype(np.int64)
    signed = np.where(phase > 1 << 31, phase - (1 << 32), phase)
    err = np.where(want == 1, signed - p.mu, signed + p.mu)
    sigma = err.std() / 2.0 ** 32
    assert sigma < 2.0 ** -7.7, (
        f"device default config (limbs={L}, lb={lb}): "
        f"sigma = {sigma} exceeds the 2^-7.7 budget (expected ~2^-8.2)")


@pytest.mark.slow
def test_cggi16_80_gates():
    """The 80-bit option (reference IYOKAN_80BIT_SECURITY build)."""
    p = params_mod.CGGI16_80
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    out, want = _bootstrap_nand(p, sk, ek, 64, 13)
    got = host.decrypt_bits(sk, out)
    np.testing.assert_array_equal(got, want)


def test_periodic_ram_refresh_budget():
    """Analytic budget for IYOKAN_RAM_REFRESH_PERIOD (engine default 16):
    with the full-store refresh running every P-th cycle, the worst-case
    RAM word -- refreshed P-1 cycles ago, accumulating one write-tree
    CMUX pass per skipped cycle at the WIDEST supported address (9 bits,
    mux-ram-addr9bit) -- must still feed a worst-case XOR (both operands
    RAM reads, +-2 scaling) with >= 5.5 sigma of margin against the 1/16
    decryption threshold.  Pure parameter arithmetic: guards the default
    period against future parameter/gadget changes."""
    p = params_mod.CGGI128
    P, a_max = 16, 9

    # per-external-product variance (l=3, Bg=64): key term + decomposition
    var_key = 2 * p.l * p.N * (p.Bg / 2) ** 2 * p.alpha1 ** 2
    eps_g = 2.0 ** -(p.l * p.Bgbit)
    var_dec = (1 + p.N) * eps_g ** 2 / 12
    var_cmux = var_key + var_dec

    # blind-rotate output variance (pre-KS): anchored to the MEASURED
    # device value for the shipping lb=2 asymmetric-gadget kernel
    # (sigma 2^-9.51, PERF.md round 2/3; the analytic sketch in params.py
    # conservatively overbounds the mod-switch term), with 2x headroom.
    var_br = (2.0 ** -9.51) ** 2 * 2
    var_ks = p.N * p.ks_t * 0.5 * p.alpha ** 2  # E[d^2]=1/2, signed digits

    # worst standing word: refreshed P-1 cycles ago, one write-tree pass
    # (a_max CMUXes) per cycle since, then read through a_max more CMUXes
    # and the lvl1->lvl0 key switch
    word = var_br + (P - 1) * a_max * var_cmux
    read_out = word + a_max * var_cmux + var_ks

    # worst-case gate input: XOR of two RAM reads (coefficients +-2)
    gate_in = 4 * read_out + 4 * read_out
    margin = (1.0 / 16.0) / gate_in ** 0.5
    assert margin >= 5.5, (
        f"periodic-refresh margin {margin:.2f} sigma at P={P}, a={a_max} "
        f"(word=2^{np.log2(word):.1f}, read_out=2^{np.log2(read_out):.1f})")

    # and the period-dependent term must stay SMALL relative to the word
    # floor (the schedule is a cost knob, not a noise knob)
    assert (P - 1) * a_max * var_cmux < 0.5 * var_br
