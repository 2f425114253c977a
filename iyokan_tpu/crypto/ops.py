"""Batched homomorphic operations (JAX).

Everything here is *batched over gates*: the unit of work is never one
ciphertext but an array of them, because the levelized executor evaluates all
ready gates of a circuit level in one call.  This replaces the reference's
per-gate `TaskTFHEppGate*` tasks scheduled on a thread pool
(reference src/iyokan_tfhepp.hpp:109-146, src/iyokan.hpp:829-883).

Shapes (u32 = jnp.uint32, u64 = jnp.uint64):
  TLWE lvl0   u32 [..., n+1]
  TLWE lvl1   u32 [..., N+1]
  TRLWE lvl1  u32 [..., 2, N]
  TRGSW lvl1  u32 [..., 2l, 2, N]     row i*l+j: digit j on part i
  TRLWE lvl2  u64 [..., 2, N2]

All arithmetic is exact: torus ops are native wrap-around uint ops.  The
gate bootstrap's negacyclic products are int8 GEMMs against Toeplitz windows
of the key (slab_extprod); the CMUX-memory and lvl2 products run through
the polymul backends' NTTs.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import replicated_sharding
from ..params import Params
from . import polymul
from .polymul import c64
from .host import EvalKey

u32 = jnp.uint32
u64 = jnp.uint64
i8 = jnp.int8
i64 = jnp.int64


# --------------------------------------------------------------------------- #
# gadget decomposition
# --------------------------------------------------------------------------- #


def gadget_digits(x: jnp.ndarray, ndig: int, p: Params) -> jnp.ndarray:
    """Top `ndig` signed gadget digits of a 32-bit torus polynomial.

    x: u32 [..., N]  ->  int32 [..., ndig, N], each digit in [-Bg/2, Bg/2).

    The offset both centers the digits (Bg/2 per level) and rounds the
    truncated tail to nearest (the 2^(31-ndig*Bgbit) term) -- without the
    rounding bit the recomposition residual has a +half-step *bias* that
    accumulates coherently through s1 and costs ~2.5 bits of noise budget.
    """
    offset = sum((p.Bg // 2) << (32 - (j + 1) * p.Bgbit) for j in range(ndig))
    offset += 1 << (31 - ndig * p.Bgbit)
    xp = x + u32(offset & 0xFFFFFFFF)
    return jnp.stack([
        ((xp >> u32(32 - (j + 1) * p.Bgbit)) & u32(p.Bg - 1)).astype(jnp.int32)
        - p.Bg // 2
        for j in range(ndig)
    ], axis=-2)


def decompose1(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    """Signed gadget decomposition, 32-bit torus.

    x: u32 [..., 2, N]  ->  int32 [..., 2l, N], digit (i*l+j) for part i.
    """
    return jnp.concatenate([gadget_digits(x[..., 0, :], p.l, p),
                            gadget_digits(x[..., 1, :], p.l, p)], axis=-2)


def decompose2(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    """Signed gadget decomposition, 64-bit torus: u64 [..., 2, N2] -> int32."""
    offset = sum((p.Bg2 // 2) << (64 - (j + 1) * p.Bgbit2) for j in range(p.l2))
    offset += 1 << (63 - p.l2 * p.Bgbit2)
    xp = x + c64(offset)
    outs = []
    for j in range(p.l2):
        shift = 64 - (j + 1) * p.Bgbit2
        d = ((xp >> np.uint64(shift)) & np.uint64(p.Bg2 - 1)).astype(jnp.int32) - p.Bg2 // 2
        outs.append(d)
    dig = jnp.stack(outs, axis=-3)
    dig = jnp.moveaxis(dig, -3, -2)
    return dig.reshape(*dig.shape[:-3], 2 * p.l2, dig.shape[-1])


# --------------------------------------------------------------------------- #
# external product / CMUX (lvl1)
# --------------------------------------------------------------------------- #


def prep_trgsw(trgsw: jnp.ndarray, p: Params,
               backend=None) -> jnp.ndarray:
    """u32 TRGSW rows [..., 2l, 2, N] -> backend-prepared transform."""
    be = backend or polymul.get_backend()
    return be.prep1(trgsw, p)


def extprod_term(g_prep: jnp.ndarray, c: jnp.ndarray, p: Params,
                 backend=None) -> jnp.ndarray:
    """TRGSW (x) TRLWE product term: returns decomp(c) * G as u32 [..., 2, N].

    g_prep: backend-prepared rows (leading dims broadcastable with c).
    """
    be = backend or polymul.get_backend()
    return be.extprod1(decompose1(c, p), g_prep, p)


def cmux(g_prep: jnp.ndarray, c1: jnp.ndarray, c0: jnp.ndarray,
         p: Params, backend=None) -> jnp.ndarray:
    """CMUX(g, c1, c0) = c0 + g (x) (c1 - c0): g ? c1 : c0.

    Semantics match TFHEpp CMUXFFT as used by the reference ROM/RAM trees
    (reference src/iyokan_tfhepp.hpp:248-271, :416-444).
    """
    return c0 + extprod_term(g_prep, c1 - c0, p, backend)


def trgsw_invert(trgsw: jnp.ndarray, p: Params) -> jnp.ndarray:
    """TRGSW(1-m) from TRGSW(m): trivial gadget of 1 minus the rows.

    Same trick as TFHEpp's CircuitBootstrappingFFTwithInv output pair
    (reference src/iyokan_tfhepp.hpp:384-407 uses {normal, inverted}).
    """
    g = np.zeros((2 * p.l, 2, p.N), np.uint32)
    for j in range(p.l):
        val = np.uint32((1 << (32 - (j + 1) * p.Bgbit)) & 0xFFFFFFFF)
        g[j, 0, 0] = val
        g[p.l + j, 1, 0] = val
    return jnp.asarray(g) - trgsw


# --------------------------------------------------------------------------- #
# polynomial rotation / sample extraction
# --------------------------------------------------------------------------- #


def _nega_roll(poly: jnp.ndarray, s: int, N: int) -> jnp.ndarray:
    """X^s * poly for a static s in [1, N]: wrap-around goes in negated."""
    if s == 0:
        return poly
    if s == N:                      # X^N = -1
        return jnp.zeros((), poly.dtype) - poly
    lo = jnp.zeros((), poly.dtype) - poly[..., N - s :]
    return jnp.concatenate([lo, poly[..., : N - s]], axis=-1)


def rot_poly(poly: jnp.ndarray, r: jnp.ndarray, N: int) -> jnp.ndarray:
    """X^r * poly mod (X^N + 1), batched: barrel shifter.

    poly: u32/u64 [..., N]; r: int32 [...] broadcastable against the leading
    dims (one rotation amount per batch row), values in [0, 2N).

    log2(2N) conditional static rolls instead of a per-element gather:
    static rolls are concats and the selects are plain elementwise ops,
    which XLA fuses into one loop.
    """
    x = poly
    nbits = (2 * N - 1).bit_length()
    for b in range(nbits):
        rolled = _nega_roll(x, 1 << b, N) if (1 << b) <= N else (
            jnp.zeros((), x.dtype) - x
        )
        bit = ((r[..., None] >> b) & 1) != 0
        x = jnp.where(bit, rolled, x)
    return x


def sample_extract(trlwe: jnp.ndarray, idx: int) -> jnp.ndarray:
    """TRLWE [..., 2, N] -> TLWE lvl1 [..., N+1] extracting coefficient idx.

    a'_j = a_{idx-j} (j <= idx), -a_{N+idx-j} (j > idx); b' = b_idx.
    (Reference counterpart: TFHEpp SampleExtractIndex used at
    src/iyokan_tfhepp.hpp:350.)
    """
    N = trlwe.shape[-1]
    a = trlwe[..., 0, :]
    j = np.arange(N)
    src = (idx - j) % N
    neg = j > idx
    a2 = jnp.where(jnp.asarray(neg), -a[..., src], a[..., src])
    b = trlwe[..., 1, idx : idx + 1]
    return jnp.concatenate([a2, b], axis=-1)


# --------------------------------------------------------------------------- #
# identity key switch lvl1 -> lvl0
# --------------------------------------------------------------------------- #


def _ks_digits(a: jnp.ndarray, t: int, basebit: int, width: int) -> jnp.ndarray:
    """Signed digits of each torus coefficient, [..., t] int32."""
    base = 1 << basebit
    prec = t * basebit
    if width == 32:
        off = (1 << (32 - prec - 1)) + sum(
            (base // 2) << (32 - (j + 1) * basebit) for j in range(t)
        )
        xp = a + u32(off & 0xFFFFFFFF)
        shifts = [32 - (j + 1) * basebit for j in range(t)]
        cast = u32
    else:
        off = (1 << (64 - prec - 1)) + sum(
            (base // 2) << (64 - (j + 1) * basebit) for j in range(t)
        )
        xp = a + c64(off)
        shifts = [64 - (j + 1) * basebit for j in range(t)]
        cast = u64
    ds = [
        ((xp >> cast(s)) & cast(base - 1)).astype(jnp.int32) - base // 2
        for s in shifts
    ]
    return jnp.stack(ds, axis=-1)


def matmul_mod32(d: jnp.ndarray, key_u32: jnp.ndarray,
                 limb_bits: int) -> jnp.ndarray:
    """Exact (d @ key) mod 2^32 via bf16 limb matmuls.

    d: small signed ints [..., K]; key_u32: u32 [K, M].  Each 32-bit key
    column is split into ceil(32/limb_bits) limbs; every limb product is an
    exact integer in f32 provided K * max|d| * (2^limb_bits - 1) < 2^24
    (callers pick limb_bits accordingly): bf16 holds integers < 2^8
    exactly, and the f32 accumulation is exact below 2^24 at HIGHEST
    precision (no TF32 rounding of the operands).
    """
    nl = -(-32 // limb_bits)
    mask = (1 << limb_bits) - 1
    df = d.astype(jnp.bfloat16)
    acc = jnp.zeros((*d.shape[:-1], key_u32.shape[1]), u32)
    for l in range(nl):
        limb = ((key_u32 >> u32(limb_bits * l)) & u32(mask)).astype(
            jnp.bfloat16
        )
        part = jnp.dot(df, limb, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        acc = acc + (part.astype(jnp.int32).astype(u32) << u32(limb_bits * l))
    return acc


def key_i8_limbs(key_u32: np.ndarray) -> np.ndarray:
    """Host: u32 key matrix [K, M] -> balanced radix-256 limbs
    int8 [4, K, M] with exact reconstruction key = sum_j limb_j * 256^j
    (mod 2^32).  Centered digits fit int8 exactly, so limb matmuls run as
    s8 x s8 -> s32 GEMMs (4 limbs instead of the bf16 form's 4-6)."""
    v = key_u32.astype(np.int64)
    limbs = []
    for _ in range(4):
        l0 = ((v + 128) & 255) - 128
        limbs.append(l0.astype(np.int8))
        v = (v - l0) >> 8
    return np.stack(limbs, axis=0)


def matmul_mod32_i8(d: jnp.ndarray, key_i8: jnp.ndarray) -> jnp.ndarray:
    """Exact (d @ key) mod 2^32 via int8 limb matmuls.

    d: small signed ints [..., K] with K * max|d| * 128 < 2^31 (int32
    accumulation is exact); key_i8: balanced limbs [4, K, M] from
    key_i8_limbs.  Bit-identical to matmul_mod32 on the reconstructed
    key: limb products accumulate in int32 and the shift-add
    recombination is exact mod 2^32 (two's complement)."""
    di = d.astype(i8) if d.dtype != i8 else d
    acc = None
    for l in range(4):
        part = jnp.dot(di, key_i8[l], preferred_element_type=jnp.int32)
        term = part.astype(u32) << u32(8 * l)
        acc = term if acc is None else acc + term
    return acc


def keyswitch_10(tlwe1: jnp.ndarray, ksk_mat: jnp.ndarray,
                 p: Params) -> jnp.ndarray:
    """Identity key switch lvl1 -> lvl0 as one (limbed) matmul.

    tlwe1: u32 [..., N+1]; ksk_mat: u32 [N * t, n+1].
    The signed-digit scalar formulation turns the reference's per-digit table
    lookups (TFHEpp IdentityKeySwitch, used at src/iyokan_tfhepp.hpp:351)
    into a dense [G, N*t] x [N*t, n+1] product -- one GEMM per limb.
    Exactness: K = N*t = 16384, |d| <= 1, limb 8 bits -> sums < 2^22.
    """
    a = tlwe1[..., : p.N]
    b = tlwe1[..., p.N]
    d = _ks_digits(a, p.ks_t, p.ks_basebit, 32)          # [..., N, t]
    d = d.reshape(*d.shape[:-2], p.N * p.ks_t)
    if ksk_mat.ndim == 3 and ksk_mat.dtype == i8:
        # balanced-limb key (key_i8_limbs): int8 GEMMs, bit-identical
        acc = matmul_mod32_i8(d, ksk_mat)
    else:
        acc = matmul_mod32(d, ksk_mat, limb_bits=8)
    out = u32(0) - acc
    return out.at[..., p.n].add(b)


# --------------------------------------------------------------------------- #
# blind rotation (lvl1) and the batched gate bootstrap
# --------------------------------------------------------------------------- #


def _modswitch(x: jnp.ndarray, log2n: int) -> jnp.ndarray:
    """u32 torus -> Z_{2N} with rounding."""
    sh = 32 - log2n - 1
    return ((x + u32(1 << (sh - 1))) >> u32(sh)).astype(jnp.int32) & (
        (1 << (log2n + 1)) - 1
    )


def slab_extprod(diff: jnp.ndarray, slab_step: jnp.ndarray,
                 p: Params) -> jnp.ndarray:
    """One Toeplitz-slab external product: decomp(diff) (x) TRGSW.

    diff: u32 [G, 2, N]; slab_step: int8 [(l+lb)*N, 2*L*128], one step of
    polymul.tkey_kernel_key (fat layout, L limbs, lb b-part digits).
    Returns u32 [G, 2, N], exact mod 2^32 for the slab's key.

    The negacyclic convolution of the digits against the shared TRGSW rows
    is a matmul against Toeplitz windows of the key (polymul.tkey_prep1):

      out[g, u, 128K + b] = sum_{j,t} ext[g, j, 128(K+1) + t] * slab_j[t, ub]

    with ext = [d, -d] the negacyclic digit extension.  The slab rows are
    ordered (block, j, lane), so output block K contracts the +-extension
    rotated by 128*(l+lb)*(K+1) lanes; the N/128 rotations stack along M,
    gate-major, into ONE s8 x s8 -> s32 GEMM against the step's slab (a
    gates-sharded batch then splits the GEMM's M into whole gates, with no
    data moving between devices).  Partial sums stay in int32 (|d| <=
    Bg/2, |limb| <= 128, contraction (l+lb)*N), and the limbs recombine
    with u32 shift-adds, exact mod 2^32.
    """
    G = diff.shape[0]
    N = p.N
    NB = N // 128
    RT, C = slab_step.shape
    RR = RT // N
    L = C // 256
    d = jnp.concatenate([gadget_digits(diff[:, 0], p.l, p),
                         gadget_digits(diff[:, 1], RR - p.l, p)], axis=1)
    ext = (d.astype(i8).reshape(G, RR, NB, 128)
           .transpose(0, 2, 1, 3).reshape(G, RT))
    full = jnp.concatenate([ext, -ext], axis=1)           # [G, 2*RT]
    grp = RR * 128
    wins = jnp.stack(
        [full[:, grp * (K + 1):grp * (K + 1) + RT] for K in range(NB)],
        axis=1).reshape(G * NB, RT)
    s = jax.lax.dot_general(wins, slab_step, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    s = s.reshape(G, NB, 2, L, 128).astype(u32)
    z = s[:, :, :, 0] << u32(8 * (4 - L))
    for li in range(1, L):
        z = z + (s[:, :, :, li] << u32(8 * (4 - L + li)))
    return z.transpose(0, 2, 1, 3).reshape(G, 2, N)       # [G, 2, N]


def blind_rotate(tlwe0: jnp.ndarray, bk_prep: jnp.ndarray, testv: jnp.ndarray,
                 p: Params, backend=None) -> jnp.ndarray:
    """Batched blind rotation lvl0 -> TRLWE lvl1.

    tlwe0: u32 [G, n+1]; testv: u32 [N].  Returns u32 [G, 2, N] with phase
    testv * X^{-phase_2N}.  bk_prep selects the external product:

      int8 [n, (l+lb)*N, 2L*128]   Toeplitz slab (DeviceKeys default):
                                   one int8 GEMM per step, slab_extprod;
      [n, 2l, 2, P, N]             backend NTT transform of bk;
      [ceil(n/2), 6l, 2, P, N]     the 2-bit unrolled NTT key (bku).

    The whole gate batch advances through the n CMUX steps together: the
    per-step TRGSW is shared (it is the bootstrapping key), only the rotation
    amounts differ per row.  This is the batched inversion of the
    reference's one-bootstrap-per-task design.  Under an active mesh the
    gates axis of tlwe0 stays sharded: every op here is row-parallel
    against the replicated key, so GSPMD partitions the loop as it is.
    """
    G = tlwe0.shape[0]
    abar = _modswitch(tlwe0[:, : p.n], p.logN)           # [G, n]
    bbar = _modswitch(tlwe0[:, p.n], p.logN)             # [G]

    acc_b = rot_poly(
        jnp.broadcast_to(testv, (G, p.N)), (-bbar) % (2 * p.N), p.N
    )
    acc = jnp.stack([jnp.zeros((G, p.N), u32), acc_b], axis=1)  # [G, 2, N]

    if bk_prep.dtype == i8:
        def body(i, acc):
            r = abar[:, i][:, None]                      # [G, 1] per part
            rot = rot_poly(acc, jnp.broadcast_to(r, acc.shape[:-1]), p.N)
            g = jax.lax.dynamic_index_in_dim(bk_prep, i, axis=0,
                                             keepdims=False)
            return acc + slab_extprod(rot - acc, g, p)

        return jax.lax.fori_loop(0, p.n, body, acc)

    be = backend or polymul.get_backend()
    # bk row count distinguishes the plain key (2l rows/step) from the
    # 2-bit unrolled key (3*2l rows per key-bit *pair*): the unrolled form
    #   X^(a1 s1 + a2 s2) = 1 + s1(1-s2)(X^a1 - 1) + s2(1-s1)(X^a2 - 1)
    #                         + s1 s2 (X^(a1+a2) - 1)
    # halves the sequential depth at 1.5x products per consumed key bit,
    # fused into one 3*2l-row external product.
    if bk_prep.shape[-4] == 6 * p.l:
        nh = bk_prep.shape[0]
        pad = 2 * nh - p.n
        if pad:
            abar = jnp.concatenate(
                [abar, jnp.zeros((G, pad), abar.dtype)], axis=1
            )
        a1s = abar[:, 0::2]
        a2s = abar[:, 1::2]
        a12s = (a1s + a2s) % (2 * p.N)

        def body(i, acc):
            sh = acc.shape[:-1]
            d = jnp.concatenate(
                [
                    decompose1(
                        rot_poly(acc, jnp.broadcast_to(
                            aa[:, i][:, None], sh), p.N) - acc, p
                    )
                    for aa in (a1s, a2s, a12s)
                ],
                axis=-2,
            )                                            # [G, 3*2l, N]
            g = jax.lax.dynamic_index_in_dim(bk_prep, i, axis=0,
                                             keepdims=False)
            return acc + be.extprod1(d, g, p)

        return jax.lax.fori_loop(0, nh, body, acc)

    def body(i, acc):
        r = abar[:, i][:, None]                          # [G, 1] per part
        rot = rot_poly(acc, jnp.broadcast_to(r, acc.shape[:-1]), p.N)
        diff = rot - acc
        g = jax.lax.dynamic_index_in_dim(bk_prep, i, axis=0, keepdims=False)
        return acc + be.extprod1(decompose1(diff, p), g, p)

    return jax.lax.fori_loop(0, p.n, body, acc)


def gate_bootstrap_tlwe1(pre: jnp.ndarray, bk_prep: jnp.ndarray,
                         p: Params, backend=None) -> jnp.ndarray:
    """pre-linear-combined TLWE lvl0 batch -> TLWE lvl1 (+-mu) batch."""
    testv = jnp.full((p.N,), u32(p.mu))
    acc = blind_rotate(pre, bk_prep, testv, p, backend)
    return sample_extract(acc, 0)


# --------------------------------------------------------------------------- #
# blind rotation lvl2 (circuit bootstrapping inner loop)
# --------------------------------------------------------------------------- #


def blind_rotate2(tlwe0: jnp.ndarray, bk2_prep: jnp.ndarray,
                  testv: jnp.ndarray, p: Params, backend=None) -> jnp.ndarray:
    """Batched blind rotation lvl0 -> TRLWE lvl2 (64-bit torus)."""
    be = backend or polymul.get_backend()
    G = tlwe0.shape[0]
    abar = _modswitch(tlwe0[:, : p.n], p.logN2)
    bbar = _modswitch(tlwe0[:, p.n], p.logN2)

    acc_b = rot_poly(
        jnp.broadcast_to(testv, (G, p.N2)), (-bbar) % (2 * p.N2), p.N2
    )
    acc = jnp.stack([jnp.zeros((G, p.N2), u64), acc_b], axis=1)

    # 2-bit unrolled CB key (rows per pair step: 3*2l2, see host.genevalkey
    # bk2u): halves the sequential depth of this latency-bound loop.
    if bk2_prep.shape[-4] == 6 * p.l2:
        nh = bk2_prep.shape[0]
        pad = 2 * nh - p.n
        if pad:
            abar = jnp.concatenate(
                [abar, jnp.zeros((G, pad), abar.dtype)], axis=1
            )
        a1s = abar[:, 0::2]
        a2s = abar[:, 1::2]
        a12s = (a1s + a2s) % (2 * p.N2)

        def body_u(i, acc):
            sh = acc.shape[:-1]
            d = jnp.concatenate(
                [
                    decompose2(
                        rot_poly(acc, jnp.broadcast_to(
                            aa[:, i][:, None], sh), p.N2) - acc, p
                    )
                    for aa in (a1s, a2s, a12s)
                ],
                axis=-2,
            )                                            # [G, 3*2l2, N2]
            g = jax.lax.dynamic_index_in_dim(bk2_prep, i, axis=0,
                                             keepdims=False)
            return acc + be.extprod2(d, g, p)

        return jax.lax.fori_loop(0, nh, body_u, acc)

    def body(i, acc):
        r = abar[:, i][:, None]
        rot = rot_poly(acc, jnp.broadcast_to(r, acc.shape[:-1]), p.N2)
        diff = rot - acc
        g = jax.lax.dynamic_index_in_dim(bk2_prep, i, axis=0, keepdims=False)
        return acc + be.extprod2(decompose2(diff, p), g, p)

    return jax.lax.fori_loop(0, p.n, body, acc)


def sample_extract2(trlwe2: jnp.ndarray, idx: int) -> jnp.ndarray:
    return sample_extract(trlwe2, idx)


# --------------------------------------------------------------------------- #
# private functional key switch lvl2 -> lvl1, circuit bootstrapping
# --------------------------------------------------------------------------- #


def privks(tlwe2: jnp.ndarray, pksk_mat: jnp.ndarray, part: int,
           p: Params) -> jnp.ndarray:
    """TLWE lvl2 (u64) -> TRLWE lvl1 (u32) under f0(x) = -s1*x (part=0) or
    f1(x) = x (part=1).

    pksk_mat: u32 [N2 * t21, 2 * N].
    Exactness: K = N2*t = 20480, |d| <= 4, limb 6 bits -> sums < 2^23.
    """
    a = tlwe2[..., : p.N2]
    b = tlwe2[..., p.N2]
    d = _ks_digits(a, p.pks_t, p.pks_basebit, 64)        # [..., N2, t]
    d = d.reshape(*d.shape[:-2], p.N2 * p.pks_t)
    if pksk_mat.ndim == 3 and pksk_mat.dtype == i8:
        # balanced-limb key: |d| <= 4, K*4*128 = 2^23.3 -- exact in i32
        acc = matmul_mod32_i8(d, pksk_mat)
    else:
        acc = matmul_mod32(d, pksk_mat, limb_bits=6)     # [..., 2N]
    out = (u32(0) - acc).reshape(*acc.shape[:-1], 2, p.N)
    b32 = ((b + c64(1 << 31)) >> np.uint64(32)).astype(u32)
    # trivial realization of f(b): f1 -> b-part const, f0 -> a-part const
    return out.at[..., part, 0].add(b32)


def circuit_bootstrap(tlwe0: jnp.ndarray, bk2_prep: jnp.ndarray,
                      pksk_mats: Tuple[jnp.ndarray, jnp.ndarray],
                      p: Params, backend=None) -> jnp.ndarray:
    """Batched circuit bootstrapping: TLWE lvl0 bits -> TRGSW lvl1.

    For digit j (1-based): one lvl2 blind rotation with test vector
    mu_j = 2^(64-j*Bgbit-1) gives TLWE2(+-mu_j); adding the trivial mu_j maps
    it to TLWE2(m * 2^(64-j*Bgbit)); the two private key switches then embed
    it as TRGSW rows (part 0: -s1*m*g_j, part 1: m*g_j).
    Functional equivalent of TFHEpp CircuitBootstrappingFFT as used by the
    reference (src/iyokan_tfhepp.hpp:194-213).
    """
    G = tlwe0.shape[0]
    # All l per-digit rotations share the same phase, so they run as ONE
    # batch of l*G rows with per-row test vectors (the reference performs
    # l separate bootstraps per CB).
    mus = np.array(
        [1 << (64 - j * p.Bgbit - 1) for j in range(1, p.l + 1)], np.uint64
    )
    testv = jnp.repeat(jnp.asarray(mus, u64)[:, None], p.N2, axis=1)  # [l,N2]
    testv = jnp.repeat(testv, G, axis=0)                 # [l*G, N2]
    batch = jnp.tile(tlwe0, (p.l, 1))                    # [l*G, n+1]
    acc2 = blind_rotate2(batch, bk2_prep, testv, p, backend)
    tl2 = sample_extract2(acc2, 0)                       # [l*G, N2+1]
    tl2 = tl2.at[..., p.N2].add(
        jnp.repeat(jnp.asarray(mus, u64), G, axis=0)
    )
    parts = []
    for part in (0, 1):
        r = privks(tl2, pksk_mats[part], part, p)        # [l*G, 2, N]
        parts.append(r.reshape(p.l, G, 2, p.N))
    rows = jnp.concatenate(parts, axis=0)                # [2l, G, 2, N]
    return jnp.moveaxis(rows, 0, -3)                     # [G, 2l, 2, N]


# --------------------------------------------------------------------------- #
# device-resident keys
# --------------------------------------------------------------------------- #

def tkey_default_config(p: Params):
    """The Toeplitz-slab config the engine uses when no IYOKAN_* knob
    overrides it: (limbs, lb).  Single source of truth for from_evalkey
    AND the noise-regression test (test_noise_and_params.py), so a default
    flip that eats the noise margin fails in CI, not in a 100k-gate run."""
    L = int(os.environ.get("IYOKAN_TKEY_LIMBS", "3"))
    # default lb=2 (asymmetric gadget): drops the least-significant b-part
    # digit rows, cutting contraction rows 2l -> l+2 (5/6 of the MACs at
    # l=3).  The dropped digit's error enters the phase directly (not via
    # the secret): sigma 2^-9.51 pre-KS vs 2^-9.73 at lb=l, well inside
    # the 2^-8.2 budget (test_noise_and_params.py asserts this config).
    lb = int(os.environ.get("IYOKAN_TK_LB", str(min(2, p.l))))
    if not 1 <= lb <= p.l:
        raise ValueError(
            f"IYOKAN_TK_LB={lb} out of range: need 1 <= lb <= l={p.l}")
    return L, lb


# Bounded LRU: one prepared key set is GBs on device (the slab alone is
# 635 x 5120 x 768 int8 = 2.5 GB at cggi128), so only the most recent few
# (params, config, fingerprint) variants are pinned; older entries are
# dropped so the device allocator can reclaim them.
_DEVICE_KEY_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_DEVICE_KEY_CACHE_MAX = int(os.environ.get("IYOKAN_KEY_CACHE_SLOTS", "2"))


def _slab_disk_path(cache_key):
    """On-disk cache location for the expanded slab, or None (default).

    The host-side Toeplitz expansion of a cggi128 key is tens of seconds
    for a 2.5 GB int8 slab that np.load brings back much faster, so
    processes that share a key can share its slab through the directory
    named by IYOKAN_SLAB_CACHE.  Keyed by the same fingerprint tuple as
    the in-process LRU (key material hash + every prep-affecting env
    knob), so a stale hit is as unlikely as a wrong in-process hit."""
    d = os.environ.get("IYOKAN_SLAB_CACHE", "")
    if not d:
        return None
    import hashlib

    tag = hashlib.sha1(repr(cache_key).encode()).hexdigest()[:16]
    return os.path.join(d, f"tkslab-{tag}.npy")


def _load_or_build_slab(src, p: Params, L: int, lb: int, cache_key):
    spath = _slab_disk_path(cache_key)
    if spath and os.path.exists(spath):
        try:
            return np.load(spath)
        except (OSError, ValueError):
            pass
    slab = polymul.tkey_kernel_key(src, p, L, lb=lb)
    if spath:
        try:
            os.makedirs(os.path.dirname(spath), exist_ok=True)
            tmp = f"{spath}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, slab)
            os.replace(tmp, spath)
        except OSError:
            pass
    return slab


@dataclasses.dataclass
class DeviceKeys:
    """Evaluation key pre-transformed for the runtime ops.

    Registered as a jax pytree so jitted entry points take the keys as an
    *argument*: closing over them would embed hundreds of MB of key material
    as HLO constants.
    """

    params: Params
    backend: object         # polymul backend
    bkntt: jnp.ndarray      # BK for blind_rotate: int8 slab or NTT prep
    ksk_mat: jnp.ndarray    # u32 [N*t, n+1]
    bk2ntt: jnp.ndarray     # backend-prepared BK2, leading [n] axis (or [0])
    pksk_mats: Tuple[jnp.ndarray, jnp.ndarray]  # u32 [N2*t21, 2N] each
    bkuntt: jnp.ndarray = None  # 2-bit-unrolled BK prep (latency path)
    bk2untt: jnp.ndarray = None  # 2-bit-unrolled BK2 prep (CB latency path)

    def bk_for(self, batch: int) -> jnp.ndarray:
        """Route a batch to its blind-rotate key.  The slab (the default
        route) serves every batch size; on the NTT route, batches of at
        most 256 rows take the 2-bit unrolled key (half the sequential
        depth)."""
        if self.bkuntt is not None and batch <= 256:
            return self.bkuntt
        return self.bkntt

    def bk2_for(self) -> jnp.ndarray:
        """CB batches are always tiny (one row per address bit), so the
        depth-halved unrolled key wins whenever present."""
        if self.bk2untt is not None:
            return self.bk2untt
        return self.bk2ntt

    @staticmethod
    def from_evalkey(ek: EvalKey, with_cb: bool = True,
                     backend=None) -> "DeviceKeys":
        """Prepare ek for the device.  IYOKAN_BR_IMPL picks the gate
        bootstrap's external product: "tkey" (default, every platform) is
        the Toeplitz-slab int8 GEMM (blind_rotate / slab_extprod); "ntt"
        is the backend's NTT transform of bk.

        Under an active mesh (parallel.mesh) every key is placed whole on
        each device of the mesh as it is built, so each device, the first
        included, holds one copy."""
        p = ek.params
        be = backend or polymul.get_backend()
        if ek.bk2.shape[0] == 0:
            with_cb = False
        impl = os.environ.get("IYOKAN_BR_IMPL", "tkey")
        if impl not in ("tkey", "ntt"):
            raise ValueError(
                f"IYOKAN_BR_IMPL={impl!r}: expected 'tkey' or 'ntt'")

        # Device-key prep is expensive (the slab is a 2.5 GB host build +
        # transfer at cggi128): cache on key-material fingerprint +
        # prep-affecting config so repeated engine builds within one
        # process (e.g. the integration registry) reuse it.
        import hashlib

        # Prefix hash: only the leading rows of each key component are
        # hashed, on the assumption that an eval key's components come from
        # a single RNG stream (any material difference shows up in the first
        # rows).  Keys hand-assembled from mixed streams must not share a
        # process with this cache.
        h = hashlib.sha1()
        h.update(np.asarray(ek.bk[:2]).tobytes())
        h.update(np.asarray(ek.ksk[:1]).tobytes())
        if with_cb:
            h.update(np.asarray(ek.bk2[:1]).tobytes())
            h.update(np.asarray(ek.pksk[:1, :1]).tobytes())
            if ek.bk2u is not None and ek.bk2u.size:
                h.update(np.asarray(ek.bk2u[:1]).tobytes())
        if ek.bku is not None:
            h.update(np.asarray(ek.bku[:1]).tobytes())
        rep = replicated_sharding()
        cache_key = (
            p.name, bool(with_cb), be.name, h.hexdigest(),
            tuple(os.environ.get(k) for k in (
                "IYOKAN_BR_IMPL", "IYOKAN_TKEY_LIMBS", "IYOKAN_NO_UNROLL",
                "IYOKAN_TK_LB", "IYOKAN_KS_I8")),
            None if rep is None else tuple(
                d.id for d in rep.mesh.devices.flat),
        )
        hit = _DEVICE_KEY_CACHE.get(cache_key)
        if hit is not None:
            _DEVICE_KEY_CACHE.move_to_end(cache_key)
            return hit

        def put(x):
            """host array -> device(s)"""
            return jax.device_put(x, rep)

        def prep(f, x):
            """jitted key transform, its output placed like put's"""
            kw = {} if rep is None else {"out_shardings": rep}
            return jax.jit(f, **kw)(x)

        if impl == "tkey":
            L, lb = tkey_default_config(p)
            if L < 4 and np.any(
                    ek.bk[:2, :, 0, :] & ((1 << (8 * (4 - L))) - 1)):
                # host.genevalkey quantizes bk masks to the 256-grid so the
                # truncated slab is exact on the mask component; a key with
                # full-torus masks (pre-quantization snapshot, or
                # IYOKAN_BK_MASK_BITS=32) gets ~2^-6 phase noise from the
                # slab -- enough to corrupt cascaded gates.
                import warnings

                warnings.warn(
                    "eval key has unquantized bootstrapping-key masks: the "
                    f"{L}-limb Toeplitz slab adds ~2^-6 phase noise "
                    "on such keys. Regenerate the eval key (host.genevalkey "
                    "quantizes masks by default) or set IYOKAN_TKEY_LIMBS=4.")
            bkntt = put(_load_or_build_slab(ek.bk, p, L, lb, cache_key))
        else:
            bkntt = prep(lambda bk: be.prep1(bk, p), jnp.asarray(ek.bk))
        bkuntt = None
        # the 2-bit-unrolled NTT key: the NTT route's small-batch key
        if (impl == "ntt" and ek.bku is not None
                and not os.environ.get("IYOKAN_NO_UNROLL")):
            bku = ek.bku.reshape(ek.bku.shape[0], 3 * 2 * p.l, 2, p.N)
            bkuntt = prep(lambda bk: be.prep1(bk, p), jnp.asarray(bku))
        # key switches as int8 limb matmuls on the mxu backend (bit-identical
        # to the bf16 limb path; IYOKAN_KS_I8=0 restores u32 keys)
        ks_i8 = (be.name == "mxu"
                 and os.environ.get("IYOKAN_KS_I8", "1") != "0")
        ksk_flat = ek.ksk.reshape(p.N * p.ks_t, p.n + 1)
        ksk_mat = put(key_i8_limbs(ksk_flat) if ks_i8 else ksk_flat)

        bk2untt = None
        if with_cb:
            bk2ntt = prep(lambda bk2: be.prep2(bk2, p),
                          jnp.asarray(ek.bk2, u64))
            if (ek.bk2u is not None and ek.bk2u.size
                    and not os.environ.get("IYOKAN_NO_UNROLL")):
                b2u = ek.bk2u.reshape(
                    ek.bk2u.shape[0], 3 * 2 * p.l2, 2, p.N2
                )
                bk2untt = prep(lambda z: be.prep2(z, p),
                               jnp.asarray(b2u, u64))
            pk = ek.pksk  # u32 [2, N2, t, 2, N]
            mats = tuple(
                put(key_i8_limbs(pk[i].reshape(p.N2 * p.pks_t, 2 * p.N))
                    if ks_i8 else
                    pk[i].reshape(p.N2 * p.pks_t, 2 * p.N))
                for i in (0, 1)
            )
        else:
            bk2ntt = prep(lambda z: be.prep2(z, p),
                          jnp.zeros((0, 2 * p.l2, 2, p.N2), u64))
            mats = (
                put(np.zeros((p.N2 * p.pks_t, 2 * p.N), np.uint32)),
                put(np.zeros((p.N2 * p.pks_t, 2 * p.N), np.uint32)),
            )
        dk = DeviceKeys(p, be, bkntt, ksk_mat, bk2ntt, mats, bkuntt,
                        bk2untt)
        _DEVICE_KEY_CACHE[cache_key] = dk
        while len(_DEVICE_KEY_CACHE) > _DEVICE_KEY_CACHE_MAX:
            _DEVICE_KEY_CACHE.popitem(last=False)
        return dk


jax.tree_util.register_pytree_node(
    DeviceKeys,
    lambda dk: (
        (dk.bkntt, dk.ksk_mat, dk.bk2ntt, dk.pksk_mats, dk.bkuntt,
         dk.bk2untt),
        (dk.params, dk.backend),
    ),
    lambda aux, children: DeviceKeys(aux[0], aux[1], *children),
)


# --------------------------------------------------------------------------- #
# batched homomorphic gates
# --------------------------------------------------------------------------- #


def gate_linear(A: jnp.ndarray, B: jnp.ndarray, ca: jnp.ndarray,
                cb: jnp.ndarray, kmu: jnp.ndarray, p: Params) -> jnp.ndarray:
    """pre = ca*A + cb*B + k*mu per row; coefficients int32 [G]."""
    pre = A * ca[:, None].astype(u32) + B * cb[:, None].astype(u32)
    return pre.at[:, p.n].add((kmu * p.mu).astype(u32))


def hom_not(c: jnp.ndarray) -> jnp.ndarray:
    """NOT: torus negation, no bootstrap (reference HomNOT)."""
    return (-c.astype(jnp.int64)).astype(u32) if c.dtype != u32 else (u32(0) - c)
