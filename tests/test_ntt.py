import numpy as np
import jax.numpy as jnp

from iyokan_tpu.crypto import ntt
from iyokan_tpu.crypto.host import negacyclic_conv_i64


def test_roundtrip():
    N = 256
    rng = np.random.default_rng(0)
    x = rng.integers(0, ntt.P1, (4, N), dtype=np.int64)
    for pi in (0, 1):
        p = ntt.PRIMES[pi]
        y = ntt.ntt_fwd(jnp.asarray(x % p), N, pi)
        z = ntt.ntt_inv(y, N, pi)
        np.testing.assert_array_equal(np.asarray(z), x % p)


def test_negacyclic_conv_vs_reference():
    N = 128
    rng = np.random.default_rng(1)
    digits = rng.integers(-32, 32, (3, N), dtype=np.int64)
    other = rng.integers(0, 1 << 32, (3, N), dtype=np.int64)
    want = negacyclic_conv_i64(digits, other).astype(np.uint32)
    got = ntt.negacyclic_mul_exact_u32(
        jnp.asarray(digits), jnp.asarray(other.astype(np.uint32)), N
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_crt_center():
    vals = np.array([0, 1, -1, 2**51, -(2**51)], dtype=np.int64)
    r1 = jnp.asarray(vals % ntt.P1)
    r2 = jnp.asarray(vals % ntt.P2)
    got = ntt.crt_center(r1, r2)
    np.testing.assert_array_equal(np.asarray(got), vals)


def test_full_fwd_matches_4step():
    """Single-matmul digit NTT (int8/s32 config) is bit-identical to the
    4-step transform for every prime at both levels."""
    import numpy as np
    import jax.numpy as jnp
    from iyokan_tpu.crypto import polymul as pm

    rng = np.random.default_rng(7)
    for N, primes, bound in ((1024, pm.PRIMES1, 32), (2048, pm.PRIMES2, 128)):
        tabs = pm.tables(N, primes)
        x = rng.integers(-bound, bound, size=(3, N)).astype(np.int32)
        x[0, 0], x[0, 1] = bound - 1, -bound
        for pi, tab in enumerate(tabs):
            import jax
            ref = np.asarray(jax.jit(
                lambda v: pm._fwd(v, N, tab, small_input=True)
            )(jnp.asarray(x)))
            fh, fl = pm.full_fwd_tables(N, primes)[pi]
            # emulate the int32-accumulator matmul exactly in numpy
            zh = x.astype(np.int64) @ fh.astype(np.int64)
            zl = x.astype(np.int64) @ fl.astype(np.int64)

            def cred(v, p=tab.p):
                r = v % p
                return np.where(r > p // 2, r - p, r)

            got = cred((cred(zh) << 8) + zl)
            assert np.array_equal(ref, got), (N, tab.p)


def test_twist2_matches_4step():
    """Batched-twist 2-stage transforms are bit-identical to the 4-step
    for every prime, both directions, at both levels."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from iyokan_tpu.crypto import polymul as pm

    rng = np.random.default_rng(11)
    for N, primes, bound in ((1024, pm.PRIMES1, 32), (2048, pm.PRIMES2, 128)):
        tabs = pm.tables(N, primes)
        x = rng.integers(-bound, bound, size=(2, N)).astype(np.int32)
        for pi, tab in enumerate(tabs):
            ref = np.asarray(jax.jit(
                lambda v: pm._fwd(v, N, tab, small_input=True)
            )(jnp.asarray(x)))
            got = np.asarray(jax.jit(
                lambda v: pm.fwd_twist2(v, N, primes, pi, tab)
            )(jnp.asarray(x)))
            assert np.array_equal(ref, got), ("fwd", N, tab.p)
            xr = rng.integers(-(tab.p // 2), tab.p // 2 + 1,
                              size=(2, N)).astype(np.int32)
            refi = np.asarray(jax.jit(
                lambda v: pm._inv(v, N, tab)
            )(jnp.asarray(xr)))
            goti = np.asarray(jax.jit(
                lambda v: pm.inv_twist2(v, N, primes, pi, tab)
            )(jnp.asarray(xr)))
            assert np.array_equal(refi, goti), ("inv", N, tab.p)


def test_crt_direct_matches_garner():
    """Direct CRT reconstruction equals Garner for consistent residues of
    values spanning the full conv ranges."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from iyokan_tpu.crypto import polymul as pm

    rng = np.random.default_rng(12)
    v = rng.integers(-(1 << 47), 1 << 47, size=(512,)).astype(object)
    v[0], v[1] = (1 << 47) + (1 << 46), -(1 << 47) - (1 << 46)
    res = [jnp.asarray(((v % p + p // 2) % p - p // 2)
                       .astype(np.int64).astype(np.int32))
           for p in pm.PRIMES1]
    g = np.asarray(jax.jit(lambda r: pm.garner_mod32(r, pm.PRIMES1))(res))
    d = np.asarray(jax.jit(lambda r: pm.crt_direct_mod32(r, pm.PRIMES1))(res))
    assert np.array_equal(g, d)

    v2 = rng.integers(-(1 << 40), 1 << 40, size=(512,)).astype(object)
    res2 = [jnp.asarray(((v2 % p + p // 2) % p - p // 2)
                        .astype(np.int64).astype(np.int32))
            for p in pm.PRIMES2]
    g2 = np.asarray(jax.jit(lambda r: pm.garner_mod64(r, pm.PRIMES2))(res2))
    d2 = np.asarray(jax.jit(lambda r: pm.crt_direct_mod64(r, pm.PRIMES2))(res2))
    assert np.array_equal(g2, d2)
