"""Polynomial-product backends for the external product.

The single hot operation of the whole engine is

    conv[..., u, :] = sum_j  digits[..., j, :]  (*)  rows[j, u, :]

(negacyclic length-N convolution of small signed digit polynomials against
the TRGSW row polynomials), computed exactly mod 2^32 (lvl1) / 2^64 (lvl2).

Two interchangeable backends:

  CRT64Backend -- two ~31-bit primes, int64 NTT (crypto/ntt.py).  Exact and
      fast on CPU; on an accelerator 64-bit integer multiplies are emulated.

  MXUBackend -- the matrix-unit path (the GPU default).  Small NTT primes
      (12289/18433 for the 2048th-root lvl1 transforms; 12289/24577/40961
      with 4096th roots for lvl2), with
        * the NTT computed as matmuls whose operands are split into
          radix-256 limbs -- int8 inputs with s32 accumulation are exact
          for these ranges, so the tensor cores do the transforms;
        * the negacyclic psi-twist folded into the stage matrices (digits
          enter the first matmul raw, one limb wide);
        * modular reduction via an f32 Barrett (multiply by 1/p, round,
          fix up) -- no integer division anywhere;
        * TRGSW rows split into 8-bit limbs so per-limb convolutions stay
          inside the CRT range of the small primes; limbs recombine with
          plain u32/u64 shifts after an all-int32 CRT.

Range analysis (lvl1): |digit| <= Bg/2 = 32, row limb < 2^8, N = 2^10,
j-sum over 2l = 6 rows  =>  |conv_limb| <= 6*32*255*1024 < 2^25.6, and
p1*p2/2 = 12289*18433/2 > 2^26.7, so the 2-prime CRT is exact.  (lvl2:
|digit| <= 128 with Bgbit2 = 8, 10 rows, N2 = 2^11 => 2^29.3 << the 3-prime
range 2^42.)  Pointwise products of centered residues accumulate within
int32 (chunked for the largest prime).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import Params
from . import ntt as crt64ntt

u32 = jnp.uint32
u64 = jnp.uint64
i32 = jnp.int32
f32 = jnp.float32


def c64(v: int) -> jnp.ndarray:
    """64-bit unsigned constant as a 0-d array.

    Without global x64, jnp scalar constructors and numpy scalars silently
    truncate 64-bit values to 32 bits; 0-d numpy arrays with an explicit
    dtype convert correctly.
    """
    return jnp.asarray(np.array(v & 0xFFFFFFFFFFFFFFFF, np.uint64),
                       jnp.uint64)

# lvl1 transforms need 2N = 2048 | p-1; lvl2 needs 4096 | p-1.
# The lvl1 product covers the full conv range (6 * 32 * 2^32 * 1024 < 2^47
# << p1p2p3p4 / 2 ~ 2^58), so TRGSW rows enter whole -- no limb splitting --
# and the CRT recombines directly mod 2^32 via Garner's mixed radix.
PRIMES1 = (12289, 18433, 40961, 59393)
PRIMES2 = (12289, 40961, 61441)


def _pointwise_chunk(p: int) -> int:
    """Max j-terms whose centered products can accumulate in int32.

    After a Barrett the partial is within +-p/2, so `chunk` products (each
    <= (p//2)^2) fit iff p/2 + chunk*(p//2)^2 < 2^31."""
    return max(1, ((1 << 31) - 1 - p // 2) // ((p // 2) ** 2))

# Operand and accumulator types of the mxu backend's NTT matmuls (lvl2
# circuit bootstrap, CMUX memory): int8 -> s32, exact for 8-bit limbs.  On
# an H100 it took half the time of bf16 -> f32 for a circuit-bootstrap
# batch at cggi128, with bit-identical output (PERF.md, Findings).
_MM_DT = jnp.int8
_MM_ACC = jnp.int32


def _is_prime(p: int) -> bool:
    if p < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if p % q == 0:
            return p == q
    d, s = p - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, p)
        if x in (1, p - 1):
            continue
        for _ in range(s - 1):
            x = x * x % p
            if x == p - 1:
                break
        else:
            return False
    return True


def _factorize(n: int):
    fs, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1
    if n > 1:
        fs.add(n)
    return fs


@functools.lru_cache(maxsize=None)
def _generator(p: int) -> int:
    assert _is_prime(p), f"{p} is not prime"
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise AssertionError(f"no generator found for {p}")


# --------------------------------------------------------------------------- #
# modular helpers (all int32 + f32, centered representatives)
# --------------------------------------------------------------------------- #


def center_reduce(x: jnp.ndarray, p: int) -> jnp.ndarray:
    """x int32 (|x| < 2^31) -> centered residue in (-p/2, p/2], exactly.

    f32 Barrett: q = round(x/p) errs by at most ~1, leaving |r| <= 3p/2;
    one conditional fix-up pair lands in the centered range.
    """
    q = jnp.round(x.astype(f32) * np.float32(1.0 / p)).astype(i32)
    r = x - q * np.int32(p)
    r = r - np.int32(p) * (r > np.int32(p // 2)).astype(i32)
    r = r + np.int32(p) * (r < -np.int32(p // 2)).astype(i32)
    return r


def _limbs_i8(x_centered: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host: centered int matrix -> radix-256 limbs (lo in [-128,128),
    hi = (x - lo)/256), both within int8 range for p < 2^15.4."""
    lo = ((x_centered + 128) % 256) - 128
    hi = (x_centered - lo) // 256
    assert np.abs(hi).max() <= 127 and np.abs(lo).max() <= 128
    return hi.astype(np.int32), lo.astype(np.int32)


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact small-int matmul: [..., K] @ [K, M] -> int32."""
    out = jnp.einsum(
        "...k,km->...m",
        a.astype(_MM_DT), b.astype(_MM_DT),
        preferred_element_type=_MM_ACC,
    )
    return out.astype(i32)


def _mm_data2(x_centered: jnp.ndarray, mat_hi: jnp.ndarray,
              mat_lo: jnp.ndarray, p: int) -> jnp.ndarray:
    """Matmul of full-range centered residues against a limbed matrix.

    x = x1*256 + x0 (data limbs), mat = m1*256 + m0:
      z = (x1@m1)*2^16 + (x1@m0 + x0@m1)*2^8 + x0@m0
    The 2^16 partial is Barrett-reduced before scaling to stay in int32.
    """
    x0 = ((x_centered + 128) & 255) - 128
    x1 = (x_centered - x0) >> 8
    z11 = center_reduce(_mm(x1, mat_hi), p)
    zmid = _mm(x1, mat_lo) + _mm(x0, mat_hi)
    z = center_reduce(z11 * np.int32((1 << 16) % p) +
                      (zmid << 8) + _mm(x0, mat_lo), p)
    return z


# --------------------------------------------------------------------------- #
# 4-step NTT tables
# --------------------------------------------------------------------------- #


def _split_rc(N: int) -> Tuple[int, int]:
    """N = R*C with C = 128 where possible: the stage-1 matmul then contracts
    a full 128-wide axis, and stage 2's small K=R matmul is a negligible
    fraction of the work."""
    c = min(128, N)
    return N // c, c  # (R, C)


@dataclasses.dataclass(frozen=True)
class _PrimeTab:
    p: int
    # forward: stage1 [R, R] (scalar table + limbs), twiddle [R, C],
    # stage2 [C, C] limbs
    w1: np.ndarray
    w1_hi: np.ndarray
    w1_lo: np.ndarray
    t: np.ndarray
    w2_hi: np.ndarray
    w2_lo: np.ndarray
    # inverse: stage1 [C, C] limbs, twiddle [R, C], stage2 [R, R]
    iw1_hi: np.ndarray
    iw1_lo: np.ndarray
    it: np.ndarray
    iw2: np.ndarray
    iw2_hi: np.ndarray
    iw2_lo: np.ndarray


def _centered(v: int, p: int) -> int:
    v %= p
    return v - p if v > p // 2 else v


@functools.lru_cache(maxsize=None)
def tables(N: int, primes: Tuple[int, ...]) -> Tuple[_PrimeTab, ...]:
    """Transpose-free 4-step tables.

    Coefficient layout: poly index i = r*C + c viewed as [R, C] (natural
    reshape, C = 128 lanes).  NTT-domain layout: slot (q, s) stores frequency
    k = s*R + q, also as [R, C] -- only ever flattened with its own natural
    reshape.  Derivation (w = psi^2, w_R = w^C, w_C = w^R):

      fwd:  U[q,c] = sum_r A[r,c] * W1[r,q],  W1[r,q] = w_R^{rq} * psi^{rC}
            V[q,c] = U[q,c] * T[q,c],         T[q,c]  = w^{cq} * psi^{c}
            X[q,s] = sum_c V[q,c] * W2[c,s],  W2[c,s] = w_C^{cs}
      inv:  T1[q,c] = sum_s X[q,s] * iW1[s,c],  iW1[s,c] = w_C^{-sc}
            T2[q,c] = T1[q,c] * iT[q,c],        iT[q,c] = w^{-cq} psi^{-c}/N
            A[r,c]  = sum_q T2[q,c] * iW2[q,r], iW2[q,r] = w_R^{-qr} psi^{-rC}

    Every contraction maps to a plain matmul on the existing layout: no
    transposes, no reordering, which keeps XLA's fusions simple.
    """
    R, C = _split_rc(N)
    out = []
    for p in primes:
        assert (p - 1) % (2 * N) == 0, (p, N)
        g = _generator(p)
        psi = pow(g, (p - 1) // (2 * N), p)
        assert pow(psi, N, p) == p - 1
        w = (psi * psi) % p            # primitive N-th root
        wc = pow(w, R, p)              # C-th root
        wr = pow(w, C, p)              # R-th root
        ipsi = pow(psi, p - 2, p)
        iw = pow(w, p - 2, p)
        iwc = pow(wc, p - 2, p)
        iwr = pow(wr, p - 2, p)
        ninv = pow(N, p - 2, p)

        w1 = np.array(
            [[_centered(pow(wr, r * q, p) * pow(psi, r * C, p), p)
              for q in range(R)] for r in range(R)], np.int64)
        t = np.array(
            [[_centered(pow(w, c * q, p) * pow(psi, c, p), p)
              for c in range(C)] for q in range(R)], np.int64)
        w2 = np.array(
            [[_centered(pow(wc, c * s, p), p) for s in range(C)]
             for c in range(C)], np.int64)

        iw1 = np.array(
            [[_centered(pow(iwc, s * c, p), p) for c in range(C)]
             for s in range(C)], np.int64)
        it = np.array(
            [[_centered(pow(iw, c * q, p) * pow(ipsi, c, p) * ninv, p)
              for c in range(C)] for q in range(R)], np.int64)
        iw2 = np.array(
            [[_centered(pow(iwr, q * r, p) * pow(ipsi, r * C, p), p)
              for r in range(R)] for q in range(R)], np.int64)

        w2h, w2l = _limbs_i8(w2)
        iw1h, iw1l = _limbs_i8(iw1)
        w1h, w1l = _limbs_i8(w1)
        iw2h, iw2l = _limbs_i8(iw2)
        out.append(_PrimeTab(
            p, w1.astype(np.int64), w1h, w1l, t.astype(np.int32), w2h, w2l,
            iw1h, iw1l, it.astype(np.int32), iw2.astype(np.int64),
            iw2h, iw2l,
        ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def full_fwd_tables(N: int, primes: Tuple[int, ...]):
    """Whole forward NTT as ONE [N, N] matrix per prime (radix-256 limbs).

    Same slot layout as the 4-step `_fwd` (flat index q*C+s holds frequency
    s*R+q): column f of the matrix is psi^i * w^(i*k(f)) centered mod p,
    i.e. exponent i*(2*k+1) of psi.  Used for the *digit* transforms, whose
    inputs fit one int8 limb: the whole transform is then a single K=N int8
    matmul pair with two Barrett reductions -- no t-twist int32
    multiplies, no intermediate stage reductions.
    """
    R, C = _split_rc(N)
    q = np.arange(R, dtype=np.int64)[:, None]
    s = np.arange(C, dtype=np.int64)[None, :]
    k_of_flat = (s * R + q).reshape(-1)            # [N] frequency per slot
    i = np.arange(N, dtype=np.int64)[:, None]
    e = (i * (2 * k_of_flat[None, :] + 1)) % (2 * N)
    out = []
    for p in primes:
        g = _generator(p)
        psi = pow(g, (p - 1) // (2 * N), p)
        psi_pows = np.empty(2 * N, np.int64)
        v = 1
        for j in range(2 * N):
            psi_pows[j] = v
            v = v * psi % p
        F = psi_pows[e]
        Fc = np.where(F > p // 2, F - p, F)
        fh, fl = _limbs_i8(Fc)
        out.append((fh.astype(np.int8), fl.astype(np.int8)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _crt_direct_consts(primes: Tuple[int, ...], mod_bits: int):
    """CRT basis for direct reconstruction mod 2^mod_bits.

    Ek = (P/pk) * ((P/pk)^-1 mod pk): x = sum res_k*Ek - m*P with
    m = round(sum res_k * Ek/P).  The f32 estimate of m is exact because the
    true ratio is within |v|/P of an integer (v = the conv result, orders of
    magnitude below P/2), while the f32 accumulation error is ~2^-7.
    """
    P = 1
    for p in primes:
        P *= p
    mask = (1 << mod_bits) - 1
    Eks, alphas = [], []
    for p in primes:
        q = P // p
        Ek = q * pow(q % p, p - 2, p)
        Eks.append(Ek & mask)
        alphas.append(np.float32(Ek / P))
    return tuple(Eks), tuple(alphas), P & mask


def crt_direct_mod32(res, primes) -> jnp.ndarray:
    """Direct CRT mod 2^32: ~2x fewer elementwise ops than Garner (no Barrett
    chain; one u32 MAC per prime plus one f32 dot for the mP correction)."""
    Eks, alphas, Pm = _crt_direct_consts(primes, 32)
    out = res[0].astype(u32) * u32(Eks[0])
    mf = res[0].astype(f32) * alphas[0]
    for k in range(1, len(primes)):
        out = out + res[k].astype(u32) * u32(Eks[k])
        mf = mf + res[k].astype(f32) * alphas[k]
    m = jnp.round(mf).astype(i32).astype(u32)
    return out - m * u32(Pm)


def crt_direct_mod64(res, primes) -> jnp.ndarray:
    """Direct CRT mod 2^64 (same construction as crt_direct_mod32)."""
    Eks, alphas, Pm = _crt_direct_consts(primes, 64)
    out = res[0].astype(jnp.int64).astype(u64) * c64(Eks[0])
    mf = res[0].astype(f32) * alphas[0]
    for k in range(1, len(primes)):
        out = out + res[k].astype(jnp.int64).astype(u64) * c64(Eks[k])
        mf = mf + res[k].astype(f32) * alphas[k]
    m = jnp.round(mf).astype(jnp.int64).astype(u64)
    return out - m * c64(Pm)


@functools.lru_cache(maxsize=None)
def _use_direct_crt() -> bool:
    return os.environ.get("IYOKAN_CRT", "direct") != "garner"


def crt_mod32(res, primes) -> jnp.ndarray:
    if _use_direct_crt():
        return crt_direct_mod32(res, primes)
    return garner_mod32(res, primes)


def crt_mod64(res, primes) -> jnp.ndarray:
    if _use_direct_crt():
        return crt_direct_mod64(res, primes)
    return garner_mod64(res, primes)


def garner_mod32(res, primes) -> jnp.ndarray:
    """Mixed-radix CRT directly mod 2^32 (never forms the big integer).

    res[k]: centered residues mod primes[k] (int32).  Garner digits t_k are
    small; the value c = t_0 + p_0 t_1 + p_0 p_1 t_2 + ... is accumulated
    with wrap-around u32 arithmetic, which is exactly c mod 2^32.
    """
    K = len(primes)
    ts = [res[0]]
    for k in range(1, K):
        pk = primes[k]
        # c_{k-1} mod p_k = sum_j (prod_{m<j} p_m mod p_k) * t_j
        cm = center_reduce(ts[0], pk)
        P = 1
        for j in range(1, k):
            P = (P * primes[j - 1]) % pk
            cm = center_reduce(
                cm + center_reduce(ts[j] * np.int32(_centered(P, pk)), pk), pk
            )
        Pfull = 1
        for m in range(k):
            Pfull = (Pfull * primes[m]) % pk
        inv = _centered(pow(Pfull, pk - 2, pk), pk)
        ts.append(center_reduce((res[k] - cm) * np.int32(inv), pk))

    out = ts[0].astype(u32)
    P32 = 1
    for k in range(1, K):
        P32 = (P32 * primes[k - 1]) & 0xFFFFFFFF
        out = out + u32(P32) * ts[k].astype(u32)
    return out


def garner_mod64(res, primes) -> jnp.ndarray:
    """Mixed-radix CRT mod 2^64 (same digits as garner_mod32)."""
    K = len(primes)
    ts = [res[0]]
    for k in range(1, K):
        pk = primes[k]
        cm = center_reduce(ts[0], pk)
        P = 1
        for j in range(1, k):
            P = (P * primes[j - 1]) % pk
            cm = center_reduce(
                cm + center_reduce(ts[j] * np.int32(_centered(P, pk)), pk), pk
            )
        Pfull = 1
        for m in range(k):
            Pfull = (Pfull * primes[m]) % pk
        inv = _centered(pow(Pfull, pk - 2, pk), pk)
        ts.append(center_reduce((res[k] - cm) * np.int32(inv), pk))

    out = ts[0].astype(jnp.int64).astype(u64)
    P64 = 1
    for k in range(1, K):
        P64 = (P64 * primes[k - 1]) & 0xFFFFFFFFFFFFFFFF
        out = out + c64(P64) * ts[k].astype(jnp.int64).astype(u64)
    return out


def _stage_small(x: jnp.ndarray, mat: np.ndarray, p: int,
                 in_bound: int) -> jnp.ndarray:
    """out[..., q, c] = sum_r x[..., r, c] * mat[r, q], centered-reduced.

    The contraction length R is tiny (8/16), so this unrolls into scalar
    elementwise multiply-adds: i32 products of centered residues are exact,
    no limb splitting needed.  in_bound bounds |x| for overflow chunking.
    """
    R = mat.shape[0]
    max_term = in_bound * (p // 2 + 1)
    chunk = max(1, (1 << 31) // max_term - 1)
    outs = []
    for q in range(R):
        acc = None
        pending = 0
        for r in range(R):
            m = int(mat[r, q])
            if m == 0:
                continue
            term = x[..., r, :] * np.int32(m)
            acc = term if acc is None else acc + term
            pending += 1
            if pending >= chunk:
                acc = center_reduce(acc, p)
                pending = 0
        outs.append(center_reduce(acc, p))
    return jnp.stack(outs, axis=-2)


def _mmT(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Small-int contraction over the second-minor axis:
    out[..., q, c] = sum_r a[..., r, c] * b[r, q]."""
    out = jnp.einsum(
        "...rc,rq->...qc",
        a.astype(_MM_DT), b.astype(_MM_DT),
        preferred_element_type=_MM_ACC,
    )
    return out.astype(i32)


def _stage_rows(x, w1_np, w1_hi, w1_lo, p, in_bound, small):
    """stage contraction over the small radix R.

    small=True (|x| <= 128): single-limb data, two limb matmuls.
    Otherwise two data limbs x two matrix limbs.  Falls back to unrolled
    scalar MACs when IYOKAN_STAGE_SMALL=scalar.
    """
    if os.environ.get("IYOKAN_STAGE_SMALL") == "scalar":
        return _stage_small(x, w1_np, p, in_bound)
    if small:
        z = (_mmT(x, w1_hi) << 8) + _mmT(x, w1_lo)
        return center_reduce(z, p)
    x0 = ((x + 128) & 255) - 128
    x1 = (x - x0) >> 8
    z11 = center_reduce(_mmT(x1, w1_hi), p)
    zmid = _mmT(x1, w1_lo) + _mmT(x0, w1_hi)
    return center_reduce(
        z11 * np.int32((1 << 16) % p) + (zmid << 8) + _mmT(x0, w1_lo), p
    )


def _fwd(x: jnp.ndarray, N: int, tab: _PrimeTab, small_input: bool,
         consts=None) -> jnp.ndarray:
    """Negacyclic NTT, x int32 [..., N] -> centered residues [..., N]
    (NTT-domain slot (q, s) = flat index q*C+s holds frequency s*R+q).

    consts: optional (w1_hi, w1_lo, t, w2_hi, w2_lo) jnp values in place of
    the tables' numpy constants.
    """
    R, C = _split_rc(N)
    p = tab.p
    lead = x.shape[:-1]
    a = x.reshape(*lead, R, C)
    in_bound = 128 if small_input else p // 2 + 1
    w1h, w1l, t, w2h, w2l = consts if consts is not None else (
        jnp.asarray(tab.w1_hi), jnp.asarray(tab.w1_lo),
        jnp.asarray(tab.t), jnp.asarray(tab.w2_hi), jnp.asarray(tab.w2_lo)
    )
    u = _stage_rows(a, tab.w1, w1h, w1l, p, in_bound, small_input)
    v = center_reduce(u * t, p)                       # [.., q, c]
    z = _mm_data2(v, w2h, w2l, p)
    return z.reshape(*lead, N)


@functools.lru_cache(maxsize=None)
def twist_tables(N: int, primes: Tuple[int, ...]):
    """Batched-twist 2-stage NTT tables.

    The per-element twiddle multiplies of the 4-step transform (the only
    int32 elementwise multiplies it needs) fold into the stage matrices by
    making the big stage a *batched* matmul over the small radix q:

      fwd:   X[q,s] = sum_c U[q,c] * (T[q,c]*W2[c,s])     '..qc,qcs->..qs'
      inv:   T2[q,c] = sum_s X[q,s] * (iW1[s,c]*iT[q,c])  '..qs,qsc->..qc'

    Matmul cost is the 4-step's (K=128 contractions), ~4x (fwd) / ~7.5x (inv)
    fewer MACs than the full [N,N] matrices, at one extra Barrett + limb
    split per transform.  All partial sums stay well inside int32 (K=128,
    8-bit limb operands).

    Returns per-prime (tw2_hi, tw2_lo [R,C,C], itw_hi, itw_lo [R,C,C]).
    """
    R, C = _split_rc(N)
    out = []
    for p in primes:
        g = _generator(p)
        psi = pow(g, (p - 1) // (2 * N), p)
        w = psi * psi % p
        wc = pow(w, R, p)
        ipsi = pow(psi, p - 2, p)
        iw = pow(w, p - 2, p)
        iwc = pow(wc, p - 2, p)
        ninv = pow(N, p - 2, p)
        T = np.array([[pow(w, c * q, p) * pow(psi, c, p) % p
                       for c in range(C)] for q in range(R)], np.int64)
        W2 = np.array([[pow(wc, c * s, p) for s in range(C)]
                       for c in range(C)], np.int64)
        IW1 = np.array([[pow(iwc, s * c, p) for c in range(C)]
                        for s in range(C)], np.int64)
        IT = np.array([[pow(iw, c * q, p) * pow(ipsi, c, p) * ninv % p
                        for c in range(C)] for q in range(R)], np.int64)
        tw2 = (T[:, :, None] * W2[None, :, :]) % p           # [q, c, s]
        itw = (IW1[None, :, :] * IT[:, None, :]) % p         # [q, s, c]
        tw2 = np.where(tw2 > p // 2, tw2 - p, tw2)
        itw = np.where(itw > p // 2, itw - p, itw)
        th, tl = _limbs_i8(tw2)
        ih, il = _limbs_i8(itw)
        out.append((th.astype(np.int8), tl.astype(np.int8),
                    ih.astype(np.int8), il.astype(np.int8)))
    return tuple(out)


def _bmm(a: jnp.ndarray, b: jnp.ndarray, spec: str) -> jnp.ndarray:
    """Batched small-int matmul (batch over the radix axis)."""
    return jnp.einsum(spec, a.astype(_MM_DT), b.astype(_MM_DT),
                      preferred_element_type=_MM_ACC).astype(i32)


def fwd_twist2(x: jnp.ndarray, N: int, primes: Tuple[int, ...], pi: int,
               tab: _PrimeTab) -> jnp.ndarray:
    """Forward digit NTT via the batched-twist 2-stage path."""
    R, C = _split_rc(N)
    p = tab.p
    lead = x.shape[:-1]
    a = x.reshape(*lead, R, C)
    th, tl, _, _ = twist_tables(N, primes)[pi]
    w1h = jnp.asarray(tab.w1_hi)
    w1l = jnp.asarray(tab.w1_lo)
    u = center_reduce(
        (_mmT(a, w1h) << 8) + _mmT(a, w1l), p
    )
    u0 = ((u + 128) & 255) - 128
    u1 = (u - u0) >> 8
    z11 = center_reduce(_bmm(u1, jnp.asarray(th), "...qc,qcs->...qs"), p)
    zmid = (_bmm(u1, jnp.asarray(tl), "...qc,qcs->...qs")
            + _bmm(u0, jnp.asarray(th), "...qc,qcs->...qs"))
    z = center_reduce(
        z11 * np.int32(_centered(1 << 16, p)) + (zmid << 8)
        + _bmm(u0, jnp.asarray(tl), "...qc,qcs->...qs"), p
    )
    return z.reshape(*lead, N)


def inv_twist2(x: jnp.ndarray, N: int, primes: Tuple[int, ...], pi: int,
               tab: _PrimeTab) -> jnp.ndarray:
    """Inverse NTT via the batched-twist 2-stage path (fwd slot layout)."""
    R, C = _split_rc(N)
    p = tab.p
    lead = x.shape[:-1]
    z = x.reshape(*lead, R, C)
    _, _, ih, il = twist_tables(N, primes)[pi]
    x0 = ((z + 128) & 255) - 128
    x1 = (z - x0) >> 8
    z11 = center_reduce(_bmm(x1, jnp.asarray(ih), "...qs,qsc->...qc"), p)
    zmid = (_bmm(x1, jnp.asarray(il), "...qs,qsc->...qc")
            + _bmm(x0, jnp.asarray(ih), "...qs,qsc->...qc"))
    t2 = center_reduce(
        z11 * np.int32(_centered(1 << 16, p)) + (zmid << 8)
        + _bmm(x0, jnp.asarray(il), "...qs,qsc->...qc"), p
    )
    iw2h = jnp.asarray(tab.iw2_hi)
    iw2l = jnp.asarray(tab.iw2_lo)
    t0 = ((t2 + 128) & 255) - 128
    t1 = (t2 - t0) >> 8
    z11b = center_reduce(_mmT(t1, iw2h), p)
    zmidb = _mmT(t1, iw2l) + _mmT(t0, iw2h)
    a = center_reduce(
        z11b * np.int32(_centered(1 << 16, p)) + (zmidb << 8)
        + _mmT(t0, iw2l), p
    )
    return a.reshape(*lead, N)


@functools.lru_cache(maxsize=None)
def _ntt_impl() -> str:
    """NTT implementation: 'full' (default: one N x N GEMM pair per digit
    transform), 'twist2' or '4step' (IYOKAN_NTT)."""
    v = os.environ.get("IYOKAN_NTT", "full")
    if v not in ("twist2", "full", "4step"):
        raise ValueError(
            f"IYOKAN_NTT={v!r}: expected 'full', 'twist2' or '4step'")
    return v


def fwd_digits(x: jnp.ndarray, N: int, primes: Tuple[int, ...], pi: int,
               tab: _PrimeTab) -> jnp.ndarray:
    """Forward NTT of gadget digits (one int8 limb of input).

    Dispatches on IYOKAN_NTT: whole-matrix (default), batched-twist
    2-stage, or the original 4-step.
    """
    impl = _ntt_impl()
    if impl == "twist2":
        return fwd_twist2(x, N, primes, pi, tab)
    if impl == "full":
        fh, fl = full_fwd_tables(N, primes)[pi]
        zh = center_reduce(_mm(x, jnp.asarray(fh)), tab.p)
        return center_reduce((zh << 8) + _mm(x, jnp.asarray(fl)), tab.p)
    return _fwd(x, N, tab, small_input=True)


@functools.lru_cache(maxsize=None)
def full_inv_tables(N: int, primes: Tuple[int, ...]):
    """Whole inverse NTT as ONE [N, N] matrix per prime (radix-256 limbs),
    consuming the `_fwd` slot layout: row f = q*C+s (holding frequency
    k = s*R+q) of the matrix is ninv * psi^(-i*(2k+1)) at column i."""
    R, C = _split_rc(N)
    q = np.arange(R, dtype=np.int64)[:, None]
    s = np.arange(C, dtype=np.int64)[None, :]
    k_of_flat = (s * R + q).reshape(-1)
    i = np.arange(N, dtype=np.int64)[None, :]
    e = (i * (2 * k_of_flat[:, None] + 1)) % (2 * N)
    out = []
    for p in primes:
        g = _generator(p)
        psi = pow(g, (p - 1) // (2 * N), p)
        ninv = pow(N, p - 2, p)
        ipsi = pow(psi, p - 2, p)
        ipsi_pows = np.empty(2 * N, np.int64)  # ipsi_pows[j] = ninv*ipsi^j
        v = ninv
        for j in range(2 * N):
            ipsi_pows[j] = v
            v = v * ipsi % p
        F = ipsi_pows[e]
        Fc = np.where(F > p // 2, F - p, F)
        fh, fl = _limbs_i8(Fc)
        out.append((fh.astype(np.int8), fl.astype(np.int8)))
    return tuple(out)


def inv_full(x: jnp.ndarray, N: int, primes: Tuple[int, ...], pi: int,
             tab: _PrimeTab) -> jnp.ndarray:
    """Inverse NTT via the single-matmul path.

    Full-range input splits into two radix-256 limbs; the partials
    recombine with two Barretts so every intermediate stays in int32.
    """
    fh, fl = full_inv_tables(N, primes)[pi]
    p = tab.p
    x0 = ((x + 128) & 255) - 128
    x1 = (x - x0) >> 8
    fh_j, fl_j = jnp.asarray(fh), jnp.asarray(fl)
    z11 = center_reduce(_mm(x1, fh_j), p)
    zmid = center_reduce(_mm(x1, fl_j) + _mm(x0, fh_j), p)
    return center_reduce(
        z11 * np.int32(_centered(1 << 16, p)) + (zmid << 8) + _mm(x0, fl_j),
        p,
    )


def _inv_dispatch(x: jnp.ndarray, N: int, primes: Tuple[int, ...], pi: int,
                  tab: _PrimeTab) -> jnp.ndarray:
    impl = _ntt_impl()
    if impl == "twist2":
        return inv_twist2(x, N, primes, pi, tab)
    if impl == "full":
        return inv_full(x, N, primes, pi, tab)
    return _inv(x, N, tab)


def _inv(x: jnp.ndarray, N: int, tab: _PrimeTab, consts=None) -> jnp.ndarray:
    """Inverse negacyclic NTT; consumes the _fwd slot layout."""
    R, C = _split_rc(N)
    p = tab.p
    lead = x.shape[:-1]
    z = x.reshape(*lead, R, C)                        # [.., q, s]
    iw1h, iw1l, it, iw2h, iw2l = consts if consts is not None else (
        jnp.asarray(tab.iw1_hi), jnp.asarray(tab.iw1_lo),
        jnp.asarray(tab.it), jnp.asarray(tab.iw2_hi),
        jnp.asarray(tab.iw2_lo)
    )
    t1 = _mm_data2(z, iw1h, iw1l, p)
    t2 = center_reduce(t1 * it, p)                    # [.., q, c]
    a = _stage_rows(t2, tab.iw2, iw2h, iw2l, p, p // 2 + 1, False)
    return a.reshape(*lead, N)


# --------------------------------------------------------------------------- #
# backends
# --------------------------------------------------------------------------- #


class MXUBackend:
    """Exact TRGSW external products via matmul NTTs (see module doc)."""

    name = "mxu"

    # -------------------------- lvl1 (u32) ----------------------------- #
    def prep1(self, rows_u32: jnp.ndarray, p: Params) -> jnp.ndarray:
        """rows u32 [..., RR, 2, N] -> centered NTT residues
        int32 [..., RR, 2, P1, N] (whole rows reduced mod each prime)."""
        tabs = tables(p.N, PRIMES1)
        outs = []
        for tab in tabs:
            # u32 -> residue: hi*2^16 + lo mod p, all within int32
            lo = (rows_u32 & u32(0xFFFF)).astype(i32)
            hi = (rows_u32 >> u32(16)).astype(i32)
            r = center_reduce(
                center_reduce(hi, tab.p) * np.int32((1 << 16) % tab.p) + lo,
                tab.p,
            )
            outs.append(_fwd(r, p.N, tab, small_input=False))
        return jnp.stack(outs, axis=-2)

    def extprod1(self, digits: jnp.ndarray, prep: jnp.ndarray,
                 p: Params) -> jnp.ndarray:
        """digits i32 [..., RR, N]; prep [..., RR, 2, P1, N]
        (broadcastable against digits' leading dims) -> u32 [..., 2, N]."""
        tabs = tables(p.N, PRIMES1)
        res = []
        for pi, tab in enumerate(tabs):
            dn = fwd_digits(digits, p.N, PRIMES1, pi, tab)
            g = prep[..., :, :, pi, :]                 # [..., RR, 2, N]
            prod = dn[..., :, None, :] * g
            chunk = _pointwise_chunk(tab.p)
            rr = prod.shape[-3]
            s = None
            for j0 in range(0, rr, chunk):
                part = prod[..., j0 : j0 + chunk, :, :].sum(axis=-3, dtype=i32)
                s = part if s is None else s + part
                s = center_reduce(s, tab.p)
            res.append(_inv_dispatch(s, p.N, PRIMES1, pi, tab))
        return crt_mod32(res, tuple(t.p for t in tabs))

    # -------------------------- lvl2 (u64) ----------------------------- #
    def prep2(self, rows_u64: jnp.ndarray, p: Params) -> jnp.ndarray:
        """rows u64 [..., RR, 2, N2] -> int32 [..., RR, 2, P2*4, N2]
        (16-bit limbs: |conv_limb| <= 10*128*2^16*2^11 < 2^38, within the
        3-prime range 2^41.9)."""
        # Guard against the explicit-x64 foot-gun: jnp.asarray / jit silently
        # demote uint64 inputs to uint32 unless converted with an explicit
        # dtype, which would drop the rows' high halves here.
        assert rows_u64.dtype == jnp.uint64, rows_u64.dtype
        tabs = tables(p.N2, PRIMES2)
        outs = []
        for tab in tabs:
            for l in range(4):
                limb = (
                    (rows_u64 >> np.uint64(16 * l)) & np.uint64(0xFFFF)
                ).astype(i32)
                outs.append(_fwd(center_reduce(limb, tab.p), p.N2, tab,
                                 small_input=False))
        return jnp.stack(outs, axis=-2)

    def extprod2(self, digits: jnp.ndarray, prep: jnp.ndarray,
                 p: Params) -> jnp.ndarray:
        tabs = tables(p.N2, PRIMES2)
        dn = [fwd_digits(digits, p.N2, PRIMES2, pi, tab)
              for pi, tab in enumerate(tabs)]
        primes = tuple(t.p for t in tabs)

        acc = None
        for l in range(4):
            res = []
            for pi, tab in enumerate(tabs):
                g = prep[..., :, :, pi * 4 + l, :]
                prod = dn[pi][..., :, None, :] * g
                chunk = _pointwise_chunk(tab.p)
                rr = prod.shape[-3]
                s = None
                for j0 in range(0, rr, chunk):
                    part = prod[..., j0 : j0 + chunk, :, :].sum(
                        axis=-3, dtype=i32
                    )
                    s = part if s is None else s + part
                    s = center_reduce(s, tab.p)
                res.append(_inv_dispatch(s, p.N2, PRIMES2, pi, tab))
            c64v = crt_mod64(res, primes)
            term = c64v << np.uint64(16 * l)
            acc = term if acc is None else acc + term
        return acc


class CRT64Backend:
    """int64 CRT NTT backend (CPU); see crypto/ntt.py."""

    name = "crt64"

    def prep1(self, rows_u32: jnp.ndarray, p: Params) -> jnp.ndarray:
        outs = []
        for pi, prime in enumerate(crt64ntt.PRIMES):
            r = rows_u32.astype(jnp.int64) % prime
            outs.append(crt64ntt.ntt_fwd(r, p.N, pi))
        return jnp.stack(outs, axis=-2).astype(i32)  # [..., RR, 2, P, N]

    def extprod1(self, digits, prep, p: Params):
        outs = []
        for pi, prime in enumerate(crt64ntt.PRIMES):
            dn = crt64ntt.ntt_fwd(digits.astype(jnp.int64) % prime, p.N, pi)
            g = prep[..., :, :, pi, :].astype(jnp.int64)
            prod = (dn[..., :, None, :] * g) % prime
            s = prod.sum(axis=-3) % prime
            outs.append(crt64ntt.ntt_inv(s, p.N, pi))
        return crt64ntt.crt_center(outs[0], outs[1]).astype(u32)

    def prep2(self, rows_u64: jnp.ndarray, p: Params) -> jnp.ndarray:
        assert rows_u64.dtype == jnp.uint64, rows_u64.dtype
        lo = (rows_u64 & c64(0xFFFFFFFF)).astype(jnp.int64)
        hi = (rows_u64 >> np.uint64(32)).astype(jnp.int64)
        halves = jnp.stack([lo, hi], axis=-2)         # [..., RR, 2, 2, N2]
        outs = []
        for pi, prime in enumerate(crt64ntt.PRIMES):
            outs.append(crt64ntt.ntt_fwd(halves % prime, p.N2, pi))
        # -> [..., RR, 2, P*2, N2] (prime-major, half-minor)
        st = jnp.stack(outs, axis=-3)                 # [..., RR, 2, P, 2, N2]
        return st.reshape(*st.shape[:-3], 4, st.shape[-1]).astype(jnp.int64)

    def extprod2(self, digits, prep, p: Params):
        halves = []
        for h in range(2):
            outs = []
            for pi, prime in enumerate(crt64ntt.PRIMES):
                dn = crt64ntt.ntt_fwd(
                    digits.astype(jnp.int64) % prime, p.N2, pi
                )
                g = prep[..., :, :, pi * 2 + h, :].astype(jnp.int64)
                prod = (dn[..., :, None, :] * g) % prime
                s = prod.sum(axis=-3) % prime
                outs.append(crt64ntt.ntt_inv(s, p.N2, pi))
            halves.append(crt64ntt.crt_center(outs[0], outs[1]))
        return halves[0].astype(u64) + (halves[1].astype(u64) << np.uint64(32))


_BACKENDS = {"mxu": MXUBackend(), "crt64": CRT64Backend()}


_PLATFORM_BACKENDS = {"cpu": "crt64", "gpu": "mxu"}


def get_backend(name: str = None):
    """The polynomial backend by name (IYOKAN_POLY_BACKEND), else the one
    for JAX's default platform.  A platform without an entry is an error,
    not a silent choice."""
    if name is None:
        name = os.environ.get("IYOKAN_POLY_BACKEND")
    if name is None:
        platform = jax.default_backend()
        if platform not in _PLATFORM_BACKENDS:
            raise RuntimeError(
                f"no polynomial backend for platform {platform!r}; "
                f"supported: {sorted(_PLATFORM_BACKENDS)}")
        name = _PLATFORM_BACKENDS[platform]
    return _BACKENDS[name]


# --------------------------------------------------------------------------- #
# Toeplitz-slab key expansion (the "tkey" external product)
# --------------------------------------------------------------------------- #
#
# The tkey form removes the NTT from the gate bootstrap: the negacyclic
# convolution against the *shared* per-step TRGSW rows is a plain int8
# matmul against a precomputed Toeplitz window of the key, exact mod 2^32 by
# construction -- no primes, no Barrett, no CRT (ops.slab_extprod).
#
#   out[g, u, 128K + b] = sum_{j,t} ext[g, j, 128(K+1) + t] * slab[j,u][t, b]
#
# with ext = [d, -d] the negacyclic digit extension and
# slab[t, b] = E[N - 128 + b - t], where E[m] = -key[m] for 0 <= m < N,
# +key[m + N] for -128 <= m < 0, +key[0] for m = N (signs verified by the
# unit impulse d = delta_0 and tested bit-exactly against polymul_u32).
#
# The key is limb-decomposed into balanced radix-256 int8 limbs; keeping the
# top `limbs` of 4 trades device memory (4 limbs, lb=2 = 3.3 GB at cggi128)
# against truncation error on the dropped limb.  CRITICAL noise asymmetry
# (found by a regression test): truncation on the MASK component is
# multiplied by the secret at phase time (x sqrt(N/2) ~ 22x), accumulating
# to sigma ~2^-6 over n steps -- so host.genevalkey samples bk masks on the
# 256-grid, making the 3-limb slab EXACT on the mask component; only the
# b-component truncation remains (enters the phase directly, sigma ~2^-10.6
# total, negligible vs the 2^-8.8 bootstrap noise; measured: tkey L=3 sigma
# 2^-9.73 == NTT path 2^-9.65, tests/test_noise_and_params.py).
# Replaces the cuFHE NTT bootstrap kernel role (thirdparty/cuFHE).


def tkey_prep1(bk_u32: np.ndarray, p: Params, limbs: int = 3) -> np.ndarray:
    """Host: TRGSW rows u32 [n, RR, 2, N] -> Toeplitz slabs
    int8 [n, RR, 2, limbs, N, 128] (limbs are the TOP `limbs` balanced
    radix-256 digits: scales 256^(4-limbs) .. 256^3)."""
    n, RR, two, N = bk_u32.shape
    assert N % 128 == 0 and two == 2
    key = bk_u32.astype(np.int64)
    # E[m] over m in [-128, N]: stored at index m + 128, length N + 129
    E = np.empty((n, RR, 2, N + 129), np.int64)
    E[..., 128 : 128 + N] = -key
    E[..., :128] = key[..., N - 128 :]
    E[..., 128 + N] = key[..., 0]
    # balanced radix-256 limbs, top `limbs` kept
    v = E & 0xFFFFFFFF
    v = np.where(v >> 31, v - (1 << 32), v)           # centered mod 2^32
    ls = []
    for _ in range(4):
        l0 = ((v + 128) & 255) - 128
        ls.append(l0.astype(np.int8))
        v = (v - l0) >> 8
    lim = np.stack(ls[4 - limbs :], axis=-2)          # [n, RR, 2, L, N+129]
    # slab[t, b] = E[N - 128 + b - t] = buf[(N + b) - t] with buf = lim
    # (index m+128); as_strided: stride -1 over t, +1 over b, base N + b=0
    s = lim.strides[-1]
    view = np.lib.stride_tricks.as_strided(
        lim[..., N:],                                  # base at m = N - 128
        shape=lim.shape[:-1] + (N, 128),
        strides=lim.strides[:-1] + (-s, s),
    )
    return np.ascontiguousarray(view)


def tkey_extprod_ref(digits: np.ndarray, slabs: np.ndarray,
                     limbs: int) -> np.ndarray:
    """Numpy reference of the slab matmul path (for tests): digits int
    [G, RR, N], slabs int8 [RR, 2, L, N, 128] -> u32 [G, 2, N]."""
    G, RR, N = digits.shape
    ext = np.concatenate([digits, -digits], axis=-1).astype(np.int64)
    out = np.zeros((G, 2, N), np.int64)
    for K in range(N // 128):
        w = 128 * (K + 1)
        lhs = ext[:, :, w : w + N]                     # [G, RR, N]
        for u in range(2):
            for li in range(limbs):
                z = np.einsum(
                    "gjt,jtb->gb", lhs, slabs[:, u, li].astype(np.int64)
                )
                sh = 8 * (4 - limbs + li)
                out[:, u, 128 * K : 128 * K + 128] += z << sh
    return (out & 0xFFFFFFFF).astype(np.uint32)


def tkey_kernel_key(bk_u32: np.ndarray, p: Params, limbs: int = 3,
                    lb: int = None) -> np.ndarray:
    """Host: TRGSW rows u32 [n, 2l, 2, N] -> the slab key of
    ops.slab_extprod: int8 [n, (l+lb)*N, 2*limbs*128].

    Contraction rows are ordered (t//128, j, t%128), matching the
    128-lane-interleaved digit extension, so the j-sum folds into the
    contraction: one GEMM per step.  Columns are (u, limb, 128).

    lb < p.l drops the least-significant b-part gadget rows (asymmetric
    gadget): the b-part decomposition error enters the phase directly
    (not via the secret), so 2 digits add only sigma ~ 2^-9.7 against the
    2^-8.8 bootstrap noise while cutting contraction rows 2l -> l+lb."""
    if lb is None:
        lb = p.l
    if not 1 <= lb <= p.l:
        raise ValueError(f"lb={lb} out of range: need 1 <= lb <= l={p.l}")
    rows = np.concatenate([bk_u32[:, : p.l], bk_u32[:, p.l : p.l + lb]],
                          axis=1)
    slab = tkey_prep1(rows, p, limbs)          # [n, RR, 2, L, N, 128]
    k = np.transpose(slab, (0, 1, 4, 2, 3, 5))
    n, RR, N = k.shape[:3]
    k = k.reshape(n, RR, N // 128, 128, 2 * limbs * 128)
    return np.ascontiguousarray(
        k.transpose(0, 2, 1, 3, 4).reshape(n, RR * N, 2 * limbs * 128))
