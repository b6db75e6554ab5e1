"""Genotype–haplotype scoring as a matmul chain.

This replaces the reference's SIMD popcount kernels (reference
src/LibHLA.cpp:747-819 ``hamm_d`` and the per-target files
src/LibHLA_ext_{sse2,...,avx512vpopcnt}.cpp) with a *reformulation*: for a
biallelic SNP with genotype g ∈ {0,1,2,NA} and haplotype bits (b1, b2) of a
candidate haplotype pair, the reference's masked-XOR-popcount distance
contribution depends only on s = b1 + b2:

    g = 0 : d += s            (linear:  0 + b1 + b2)
    g = 1 : d += |s - 1|      (quadratic: 1 - b1 - b2 + 2·b1·b2)
    g = 2 : d += 2 - s        (linear:  2 - b1 - b2)
    g = NA: d += 0

Summing over SNPs, the full pairwise distance matrix for one sample is

    D = alpha + v·1ᵀ + 1·vᵀ + 2 · (H ∘ m1) Hᵀ

with alpha = Σ[g==1] + 2·Σ[g==2], u = [g==0] − [g==1] − [g==2], v = H u,
m1 = [g==1], and H the {0,1} haplotype-bit matrix. The O(H²·L) popcount work
becomes one [H,L]×[L,H] matmul per sample — exact in f32/bf16 because all
values are small integers — and runs on matrix units instead of popcounts.

The per-pair likelihood weight is then ``freq_i · freq_j · MIN_RARE_FREQ**D``
(reference ADD_FREQ_MUTANT, src/LibHLA.h:223), and the posterior over
unordered HLA-genotype pairs is the allele-grouped quadratic form

    S[A,B] = W[:,A]ᵀ · exp(λ·D) · W[:,B],   W[h,A] = freq_h · [allele_h == A]

(two more matmuls), equivalent to the reference's triangular accumulation
in _PostProb2_def (src/LibHLA.cpp:1770-1830): the unordered-pair probability
is S[A,B]+S[B,A] off-diagonal and S[A,A] on the diagonal.

Numerical stability: terms are ≤ freq²; with distances ≥ dmin > 0 every term
carries exp(λ·dmin) which underflows f32 quickly, so we factor the per-sample
minimum distance out of the exponent (flash-attention-style shift) and return
it separately; normalized posteriors are unaffected and the unnormalized
"matching" sum is reconstructed in f64 on the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import LOG_MIN_RARE_FREQ

BIG = 1e9  # sentinel distance for invalid haplotype slots


def geno_coefficients(geno_codes: jax.Array, dtype=jnp.float32):
    """Per-sample distance-decomposition coefficients from genotype codes.

    geno_codes: int8/int32 [..., L] with values {0,1,2,GENO_MISSING}; padded
    SNP slots must be GENO_MISSING.

    Returns (alpha [...], u [..., L], m1 [..., L]) in `dtype`.
    """
    g = geno_codes
    is0 = (g == 0)
    is1 = (g == 1)
    is2 = (g == 2)
    u = is0.astype(dtype) - is1.astype(dtype) - is2.astype(dtype)
    m1 = is1.astype(dtype)
    alpha = is1.sum(-1).astype(dtype) + 2.0 * is2.sum(-1).astype(dtype)
    return alpha, u, m1


def pair_distance(hap_bits: jax.Array, geno_codes: jax.Array,
                  compute_dtype=jnp.float32) -> jax.Array:
    """Distance matrix between all haplotype pairs and one genotype batch.

    hap_bits: [H, L] {0,1} float; geno_codes: [N, L] codes.
    Returns D [N, H, H] (exact small integers, in f32).
    """
    dt = compute_dtype
    # no precision is set on these two contractions, and none is needed:
    # every operand is 0 or ±1 and every sum an integer of at most 2L = 256,
    # exact in any float32 matmul mode (TF32 and bf16 inputs included)
    Hb = hap_bits.astype(dt)
    alpha, u, m1 = geno_coefficients(geno_codes, dt)
    # v[n,h] = sum_l H[h,l] * u[n,l]
    v = jnp.einsum("hl,nl->nh", Hb, u, preferred_element_type=jnp.float32)
    # cross[n,h,g] = sum_l H[h,l] * H[g,l] * m1[n,l]
    hm = Hb[None, :, :] * m1[:, None, :]
    cross = jnp.einsum("nhl,gl->nhg", hm, Hb, preferred_element_type=jnp.float32)
    D = alpha[:, None, None] + v[:, :, None] + v[:, None, :] + 2.0 * cross
    return D


@functools.partial(jax.jit, static_argnames=("n_alleles", "f64"))
def posterior_scores(hap_bits, hap_freq, hap_allele, geno_codes, n_alleles,
                     f64=False):
    """Posterior scores over ordered allele pairs for a batch of samples
    against ONE classifier's haplotype list.

    hap_bits  : [H, L] {0,1}
    hap_freq  : [H] haplotype frequencies, 0 for padded slots
    hap_allele: [H] int allele index, arbitrary for padded slots
    geno_codes: [N, L] genotype codes {0,1,2,3}, 3 in padded SNP slots

    Returns dict with
      S      : [N, A, A] symmetric ordered-pair scores with the per-sample
               exp(λ·dmin) factor REMOVED (multiply back for absolute scale)
      dmin   : [N] minimum pairwise distance over valid haplotype pairs
      total  : [N] Σ S (shifted normalizer; matching = total·exp(λ·dmin))
    """
    acc = jnp.float64 if f64 else jnp.float32
    D = pair_distance(hap_bits, geno_codes)  # [N, H, H] f32
    valid = hap_freq > 0
    pair_ok = valid[:, None] & valid[None, :]
    Dm = jnp.where(pair_ok[None], D, BIG)
    dmin = jnp.min(Dm, axis=(1, 2))  # [N]
    pen = jnp.exp((LOG_MIN_RARE_FREQ * (Dm - dmin[:, None, None])).astype(acc))
    pen = jnp.where(pair_ok[None], pen, 0.0)
    # W[h, A] = freq_h * onehot(allele_h)
    W = (jax.nn.one_hot(hap_allele, n_alleles, dtype=acc)
         * hap_freq[:, None].astype(acc))  # [H, A]
    S = jnp.einsum("ha,nhg,gb->nab", W, pen, W,
                   preferred_element_type=acc,
                   precision=jax.lax.Precision.HIGHEST)
    total = jnp.sum(S, axis=(1, 2))
    return {"S": S, "dmin": dmin, "total": total}


def unordered_from_S(S):
    """Convert symmetric ordered-pair scores S to the unordered-pair
    convention (off-diagonal entries doubled, diagonal kept), still stored as
    a full symmetric matrix."""
    A = S.shape[-1]
    eye = jnp.eye(A, dtype=S.dtype)
    return S * (2.0 - eye)
