"""Fused ensemble posterior kernel for NVIDIA GPUs (Pallas, Triton route).

For each sample and each classifier c the ensemble needs

    S_c = Wᵀ · exp(λ·(D − dmin)) · W,  D = α + v⊕v + 2·(H∘m1)Hᵀ + inval

(ops/scoring.py derives the decomposition). The plain XLA path writes the
[n, H, H] distance and penalty tensors to device memory for every
classifier; this kernel keeps them in registers. Its shape follows the
attention kernels: a distance matmul, an ``exp``, then the allele-grouped
contraction.

* The grid runs over samples only. Each program loops over all classifiers
  and keeps the sample's weighted ensemble sum [Ap, Ap] in registers, so no
  reduction crosses programs.
* H is cut into tiles of ``bh`` haplotypes; a tile pair's [bh, bh] distance
  block is formed by one bf16 matmul of depth L = 128 (exact: {0,1}·{0,2}
  products, integer sums ≤ 2L in float32).
* The per-(sample, classifier) min-distance shift is taken by a first pass
  over the distance tiles (the pairs j ≥ i, D being symmetric); the second
  pass recomputes each tile, exponentiates it and contracts it. Both passes
  are loops, so the kernel's code does not grow with H.
* The two value-carrying contractions split each float32 operand into a
  bf16 high part and a bf16 residual and sum three bf16 products
  (hi·hi + hi·lo + lo·hi) in float32: about 16 mantissa bits per product,
  a relative error near 1e-5 on the posteriors. Operands arrive with W
  already split (``split_bf16``).

Outputs per sample: the weighted ensemble sum Σ_c w_c·Q_c/total_c in the
unordered convention (Q = S with doubled off-diagonal, as in
``unordered_from_S``), and log_match[c] = log w_c + log total_c + λ·dmin_c
(−inf where w_c = 0) for the matching statistic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import LOG_MIN_RARE_FREQ

BIG = 1e9
#: haplotype tile; a [64, 64] float32 tile is 16 KB, four of which fit the
#: registers of NUM_WARPS warps
TILE_H = 64
NUM_WARPS = 4


def split_bf16(x):
    """float32 x -> (hi, lo) bf16 with hi + lo ≈ x to ~16 mantissa bits."""
    hi = x.astype(jnp.bfloat16)
    return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)


def _dot3(a_hi, a_lo, b_hi, b_lo, trans_a=False):
    """float32-accurate product from three bf16 tensor-core products."""
    return (pl.dot(a_hi, b_lo, trans_a=trans_a)
            + pl.dot(a_lo, b_hi, trans_a=trans_a)
            + pl.dot(a_hi, b_hi, trans_a=trans_a))


def _kernel(hb_ref, wh_ref, wl_ref, inval_ref, g_ref, wt_ref, ens_ref,
            lm_ref, *, n_cls, bh):
    nt = hb_ref.shape[1] // bh
    Ap = ens_ref.shape[-1]
    cidx = jax.lax.broadcasted_iota(jnp.int32, wt_ref.shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, (Ap, Ap), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (Ap, Ap), 1)
    offdiag = jnp.where(ii == jj, 1.0, 2.0)
    wrow = wt_ref[...]                                   # [Cp]

    def body(c, carry):
        ens, lm = carry
        g = g_ref[c, :].astype(jnp.int32)                # [L]
        is1 = g == 1
        is2 = g == 2
        u = ((g == 0).astype(jnp.float32) - is1.astype(jnp.float32)
             - is2.astype(jnp.float32))
        m2 = jnp.where(is1, 2.0, 0.0).astype(jnp.bfloat16)
        alpha = jnp.sum(is1.astype(jnp.float32) + 2.0 * is2.astype(
            jnp.float32))

        def tile(i):
            """Haplotype tile i: bits [bh, L] and v + invalid sentinel."""
            rows = pl.ds(i * bh, bh)
            hb = hb_ref[c, rows, :]
            v = (jnp.sum(hb.astype(jnp.float32) * u[None, :], axis=1)
                 + inval_ref[c, rows])
            return hb, v

        def dist(ti, tj):
            (hi, vi), (hj, vj) = ti, tj
            cross = pl.dot(hi * m2[None, :], hj, trans_b=True)
            return alpha + vi[:, None] + vj[None, :] + cross

        def row_min(i, dmin):
            ti = tile(i)
            return jax.lax.fori_loop(
                i, nt, lambda j, d: jnp.minimum(
                    d, jnp.min(dist(ti, tile(j)))), dmin)

        dmin = jax.lax.fori_loop(0, nt, row_min, jnp.float32(3 * BIG))

        def row_sum(i, S):
            ti = tile(i)

            def col(j, T):
                pen = jnp.exp(LOG_MIN_RARE_FREQ * (dist(ti, tile(j)) - dmin))
                p_hi, p_lo = split_bf16(pen)
                cols = pl.ds(j * bh, bh)
                return T + _dot3(p_hi, p_lo, wh_ref[c, cols, :],
                                 wl_ref[c, cols, :])

            T = jax.lax.fori_loop(0, nt, col,
                                  jnp.zeros((bh, Ap), jnp.float32))
            t_hi, t_lo = split_bf16(T)
            rows = pl.ds(i * bh, bh)
            return S + _dot3(wh_ref[c, rows, :], wl_ref[c, rows, :],
                             t_hi, t_lo, trans_a=True)

        S = jax.lax.fori_loop(0, nt, row_sum,
                              jnp.zeros((Ap, Ap), jnp.float32))
        total = jnp.sum(S)
        w = jnp.sum(jnp.where(cidx == c, wrow, 0.0))
        ens = ens + S * offdiag * (w / jnp.maximum(total, 1e-30))
        lmc = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-30))
                        + jnp.log(total) + LOG_MIN_RARE_FREQ * dmin,
                        -jnp.inf)
        return ens, jnp.where(cidx == c, lmc, lm)

    ens, lm = jax.lax.fori_loop(
        0, n_cls, body,
        (jnp.zeros((Ap, Ap), jnp.float32),
         jnp.full(wt_ref.shape, -jnp.inf, jnp.float32)))
    ens_ref[...] = ens
    lm_ref[...] = lm


@functools.partial(jax.jit, static_argnames=("bh", "interpret"))
def ensemble_posterior_triton(hb, wh, wl, inval, g, wt, bh=TILE_H,
                              interpret=False):
    """Weighted ensemble posterior sums for a block of samples.

    hb [C, Hp, L] bf16 haplotype bits; wh/wl [C, Hp, Ap] bf16 split of
    W = freq ⊙ one-hot(allele); inval [C, Hp] f32, BIG on empty slots and 0
    elsewhere; g [n, C, L] int8 genotype codes gathered to each
    classifier's SNPs (3 = missing); wt [n, Cp] f32 classifier weights
    (Cp ≥ C a power of two, zero past C). Hp must be a multiple of ``bh``;
    L, Ap and Cp powers of two ≥ 16.

    Returns (ens [n, Ap, Ap], log_match [n, Cp]).
    """
    C, Hp, L = hb.shape
    Ap = wh.shape[2]
    n, Cp = wt.shape
    assert Hp % bh == 0 and g.shape == (n, C, L), (hb.shape, g.shape, bh)
    return pl.pallas_call(
        functools.partial(_kernel, n_cls=C, bh=bh),
        grid=(n,),
        in_specs=[
            pl.BlockSpec((C, Hp, L), lambda s: (0, 0, 0)),
            pl.BlockSpec((C, Hp, Ap), lambda s: (0, 0, 0)),
            pl.BlockSpec((C, Hp, Ap), lambda s: (0, 0, 0)),
            pl.BlockSpec((C, Hp), lambda s: (0, 0)),
            pl.BlockSpec((None, C, L), lambda s: (s, 0, 0)),
            pl.BlockSpec((None, Cp), lambda s: (s, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, Ap, Ap), lambda s: (s, 0, 0)),
            pl.BlockSpec((None, Cp), lambda s: (s, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n, Ap, Ap), jnp.float32),
            jax.ShapeDtypeStruct((n, Cp), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ensemble_posterior",
    )(hb, wh, wl, inval, g, wt)
