"""Exactness of the mxu polymul backend (the GPU's), run on CPU.

The default CPU configuration routes to CRT64Backend, so without this test
the int8/s32 matmul-NTT path -- the one the GPU runs for the circuit
bootstrap and the CMUX memories -- would have no CI coverage.  Both external products are compared bit-for-bit against the
plain int64 negacyclic convolution mod 2^32 / 2^64.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iyokan_tpu.crypto import polymul as pm
from iyokan_tpu.crypto.host import negacyclic_conv_i64
from iyokan_tpu.params import TOY


@pytest.fixture(params=["4step", "full"])
def mxu_int8(request, monkeypatch):
    """MXUBackend as on the GPU (int8 operands, s32 accumulation), with the
    digit transform in either implementation."""
    monkeypatch.setenv("IYOKAN_NTT", request.param)
    pm._ntt_impl.cache_clear()
    yield pm.MXUBackend()
    pm._ntt_impl.cache_clear()


def test_extprod1_exact(mxu_int8):
    p = TOY
    rng = np.random.default_rng(3)
    RR, G = 2 * p.l, 3
    rows = rng.integers(0, 1 << 32, size=(RR, 2, p.N), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    bound = p.Bg // 2
    digits = rng.integers(-bound, bound, size=(G, RR, p.N)).astype(np.int32)
    digits[0, 0, 0], digits[0, 0, 1] = bound - 1, -bound

    prep = jax.jit(lambda r: mxu_int8.prep1(r, p))(jnp.asarray(rows))
    got = np.asarray(
        jax.jit(lambda d, pr: mxu_int8.extprod1(d, pr, p))(
            jnp.asarray(digits), prep
        )
    )

    want = np.zeros((G, 2, p.N), np.uint32)
    for g in range(G):
        for u in range(2):
            acc = np.zeros(p.N, np.int64)
            for j in range(RR):
                acc += negacyclic_conv_i64(
                    digits[g, j].astype(np.int64),
                    rows[j, u].astype(np.int64),
                )
            want[g, u] = (acc % (1 << 32)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_extprod2_exact(mxu_int8):
    p = TOY
    rng = np.random.default_rng(4)
    RR, G = 2 * p.l2, 2
    rows = rng.integers(0, 1 << 63, size=(RR, 2, p.N2), dtype=np.uint64)
    rows = (rows << np.uint64(1)) | rng.integers(
        0, 2, size=(RR, 2, p.N2), dtype=np.uint64
    )
    bound = p.Bg2 // 2
    digits = rng.integers(-bound, bound, size=(G, RR, p.N2)).astype(np.int32)
    digits[0, 0, 0], digits[0, 0, 1] = bound - 1, -bound

    # NB: the explicit dtype is load-bearing -- without it jnp.asarray
    # silently demotes uint64 arrays to uint32 under explicit-x64 mode.
    prep = jax.jit(lambda r: mxu_int8.prep2(r, p))(
        jnp.asarray(rows, jnp.uint64)
    )
    got = np.asarray(
        jax.jit(lambda d, pr: mxu_int8.extprod2(d, pr, p))(
            jnp.asarray(digits), prep
        )
    )

    # reference: conv mod 2^64 via 32-bit halves of the rows (each half-conv
    # stays within int64: N2 * 128 * 2^32 = 2^50)
    want = np.zeros((G, 2, p.N2), np.uint64)
    lo = (rows & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (rows >> np.uint64(32)).astype(np.int64)
    for g in range(G):
        for u in range(2):
            alo = np.zeros(p.N2, np.int64)
            ahi = np.zeros(p.N2, np.int64)
            for j in range(RR):
                d = digits[g, j].astype(np.int64)
                alo += negacyclic_conv_i64(d, lo[j, u])
                ahi += negacyclic_conv_i64(d, hi[j, u])
            want[g, u] = (
                alo.astype(np.uint64)
                + (ahi.astype(np.uint64) << np.uint64(32))
            )
    assert np.array_equal(got, want)
