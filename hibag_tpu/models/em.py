"""EM haplotype-frequency estimation and candidate-SNP evaluation kernels.

Accelerator reformulation of the reference's training inner loops
(CAlg_EM, src/LibHLA.cpp:1000-1255; CVariableSelection evaluation,
src/LibHLA.cpp:1920-1979):

* Haplotype-pair matching per in-bag sample (PrepareHaplotypes /
  _PrepHaploMatch) becomes a batched distance matmul + per-sample min:
  the matched-pair set is exactly {(i,j) in the sample's allele blocks :
  D_ij == min D}, kept as a dense boolean mask.

* The per-sample pair lists of the reference's EM become the symmetric mask:
  summing f_i·f_j over ALL ordered masked pairs equals the reference's
  (2-δ)-weighted unordered sums, and the M-step row-sum identity
  freq_h ∝ Σ_s B_s · f_h·(M_s·f)_h / psum_s reproduces its accumulation
  (both endpoints, diagonal doubled) exactly.

* The doubled haplotype list (DoubleHaplos) is never materialized: EM state
  is freq[H, 2] (new-SNP bit 0/1 per base haplotype) and the four bilinear
  forms fA/fB x mask x fA/fB give psum for genotype 0/1/2/NA. ALL mtry
  candidate SNPs run EM simultaneously — one [S·H, H] x [H, 2·mtry] matmul
  per EM iteration instead of the reference's serial per-candidate loops.

* EraseDoubleHaplos's rare-haplotype merge/drop becomes a vectorized
  select over the [H, 2] pairs (src/LibHLA.cpp:461-515 semantics).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (EM_INIT_VAL_FRAC, EM_MAX_ITERATIONS,
                         LOG_MIN_RARE_FREQ, MIN_RARE_FREQ)
from ..ops.scoring import pair_distance

BIG = 1e9

#: precision of every contraction that carries haplotype frequencies (the EM
#: E/M-step and candidate evaluation): exact float32 products. The distance
#: matmuls (ops.scoring.pair_distance) need none: their operands are 0/±1
#: and their sums small integers, exact in TF32 and bf16 alike.
VALUE_PRECISION = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# pair matching (PrepareHaplotypes)
# ---------------------------------------------------------------------------

def _match_chunk(bits, valid, allele, geno_sel, samp_a1, samp_a2):
    D = pair_distance(bits, geno_sel)  # [S, H, H]
    ok1 = valid[None, :] & (allele[None, :] == samp_a1[:, None])  # [S, H]
    ok2 = valid[None, :] & (allele[None, :] == samp_a2[:, None])
    block = ok1[:, :, None] & ok2[:, None, :]
    block = block | jnp.swapaxes(block, 1, 2)  # symmetric closure
    Dm = jnp.where(block, D, BIG)
    dmin = jnp.min(Dm, axis=(1, 2), keepdims=True)
    return block & (Dm == dmin)


def _chunk_plan(n: int, per_sample_elems: int,
                budget_elems: int = 16 * 1024 * 1024) -> tuple:
    """(chunk, n_chunks, pad): sample-chunk size keeping the largest
    per-chunk intermediate under ~budget_elems f32 elements (64 MiB at the
    default; a budget not measured on the H100). Works for ANY n —
    callers pad the sample axis by `pad` zero-weight rows (geno missing,
    B=0: EM/eval sums are unchanged, tests/test_chunked.py) rather than
    relying on divisor-friendly sizes."""
    c = max(8, min(256, budget_elems // max(per_sample_elems, 1)))
    c = min(n, (c // 8) * 8)
    if c <= 0:
        c = min(n, 8)
    g = -(-n // c)
    return c, g, g * c - n


def _pad_samples(pad: int, *arrays):
    """Pad axis 0 of each array by `pad` rows (genotype codes with
    GENO_MISSING-compatible 3, everything else zero)."""
    if pad == 0:
        return arrays
    out = []
    for a in arrays:
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        fill = 3 if a.dtype == jnp.int8 else 0
        out.append(jnp.pad(a, width, constant_values=fill))
    return tuple(out)


@jax.jit
def match_pairs(bits, valid, allele, geno_sel, samp_a1, samp_a2):
    """Per-sample matched haplotype-pair masks.

    bits [H, L] {0,1}; valid [H] bool; allele [H] int; geno_sel [S, L] codes
    over the currently selected SNPs (missing/pad = 3); samp_a1/samp_a2 [S]
    the known HLA alleles of each in-bag sample (a1 <= a2).

    Returns mask [S, H, H] bool (symmetric), the reference's min-Hamming
    matched set (reference _PrepHaploMatch_def, src/LibHLA.cpp:1569-1636).
    Processes samples in chunks so only a [chunk, H, H] float distance
    matrix is ever materialized (the bool mask is the persistent output).
    """
    S = geno_sel.shape[0]
    H = bits.shape[0]
    c, G, pad = _chunk_plan(S, H * H, 4 * 1024 * 1024)
    if G == 1:
        return _match_chunk(bits, valid, allele, geno_sel, samp_a1, samp_a2)
    geno_sel, samp_a1, samp_a2 = _pad_samples(pad, geno_sel, samp_a1,
                                              samp_a2)

    def body(_, xs):
        gs, a1c, a2c = xs
        return None, _match_chunk(bits, valid, allele, gs, a1c, a2c)

    _, out = jax.lax.scan(
        body, None,
        (geno_sel.reshape(G, c, -1), samp_a1.reshape(G, c),
         samp_a2.reshape(G, c)))
    return out.reshape(G * c, *out.shape[2:])[:S]


# ---------------------------------------------------------------------------
# bit-packed pair masks (cohort-scale EM)
# ---------------------------------------------------------------------------

def _pack_mask(mask):
    """bool [..., H] -> uint8 [..., H//8] bitfield (H must be 8-aligned)."""
    shp = mask.shape
    m = mask.reshape(*shp[:-1], shp[-1] // 8, 8)
    w = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return (m * w).sum(-1).astype(jnp.uint8)


def _unpack_mask(packed, dtype):
    """uint8 [..., H//8] -> dtype [..., H] {0,1}."""
    bits = (packed[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    shp = packed.shape
    return bits.reshape(*shp[:-1], shp[-1] * 8).astype(dtype)


@jax.jit
def match_pairs_packed(bits, valid, allele, geno_sel, samp_a1, samp_a2):
    """Per-sample matched-pair masks, bit-packed along the trailing
    haplotype axis: uint8 [S, H, H//8] (8x the bool footprint reduction,
    64x vs the f32 masks the EM matmuls consume).

    The matched set is EM-loop-invariant, so at cohort scale the packed
    mask is computed ONCE per growth step and unpacked per chunk inside
    each E-step — replacing a per-iteration distance-matmul
    rematerialization with a cheap elementwise shift/and (the reference
    keeps per-sample pair lists across iterations for the same reason,
    src/LibHLA.cpp:1104-1255)."""
    S = geno_sel.shape[0]
    H = bits.shape[0]
    c, G, pad = _chunk_plan(S, H * H, 4 * 1024 * 1024)
    if G == 1:
        return _pack_mask(_match_chunk(bits, valid, allele, geno_sel,
                                       samp_a1, samp_a2))
    geno_sel, samp_a1, samp_a2 = _pad_samples(pad, geno_sel, samp_a1,
                                              samp_a2)

    def body(_, xs):
        gs, a1c, a2c = xs
        return None, _pack_mask(
            _match_chunk(bits, valid, allele, gs, a1c, a2c))

    _, out = jax.lax.scan(
        body, None,
        (geno_sel.reshape(G, c, -1), samp_a1.reshape(G, c),
         samp_a2.reshape(G, c)))
    return out.reshape(G * c, *out.shape[2:])[:S]


# ---------------------------------------------------------------------------
# EM over all candidates at once
# ---------------------------------------------------------------------------

def _geno_sel_masks(g, dt):
    """Loop-invariant genotype-selection masks [C, S, 3] in `dt`:
    m00 = [g==0 or NA], m01 = [g==1 or NA], m11 = [g==2 or NA] — the pair
    flags of PrepareNewSNP expressed as selectors (hoisted out of the EM
    while_loop: they never change across iterations)."""
    is0, is1, is2 = (g == 0), (g == 1), (g == 2)
    isna = ~(is0 | is1 | is2)
    return jnp.stack([(is0 | isna).astype(dt), (is1 | isna).astype(dt),
                      (is2 | isna).astype(dt)], axis=-1)


def _em_estep_chunk(fA, fB, mask_f, B_c, m_c, total_n):
    """E+M contributions from one sample chunk.

    fA/fB [C, H]; mask_f [c, H, H] in the compute dtype; B_c [c];
    m_c [C, c, 3] genotype-selection masks (_geno_sel_masks).
    Returns (dfA, dfB [C, H], dll [C]) — additive contributions.
    Compute dtype follows fA (f32 normally; f64 for the opt-in parity path).

    The per-genotype selections factorize: with q_XY = f_X ⊙ t_Y
    (t_Y[c,s,h] = Σ_j mask[s,h,j]·f_Y[c,j]), the M-step numerators are
    num0 = fA ⊙ (m00·t0 + m01·t1) and num1 = fB ⊙ (m01·t0 + m11·t1), so
    the weighted sample sums become four [C,c]×[C,c,H] batched reductions
    and the [C,c,H] q/num tensors are never materialized (memory traffic, not
    FLOPs, bounds this kernel). The psum expansion
    m00·s00 + m01·s01 + m01·s10 + m11·s11 evaluates left-to-right, which
    reproduces the former nested-where selection BITWISE for every
    genotype case (0·x terms vanish exactly; the all-flagged NA case keeps
    the ((s00+s01)+s10)+s11 association).
    """
    C, H = fA.shape
    dt = fA.dtype
    # frequency products span 1e-5..1: full float32 passes (a TF32 or
    # single-bf16 pass would keep ~3 digits and can flip the greedy
    # log-likelihood comparisons)
    hp = VALUE_PRECISION
    # t[b, c, s, h] = sum_j mask[s,h,j] * f_b[c,j]
    fboth = jnp.concatenate([fA, fB], axis=0)              # [2C, H]
    t = jnp.einsum("shj,cj->csh", mask_f, fboth,
                   preferred_element_type=dt,
                   precision=hp)                            # [2C, c, H]
    t0, t1 = t[:C], t[C:]                                   # [C, c, H]
    # fused multiply+reduce (NOT a dot-general): its accumulation order is
    # batch-size-invariant, so sharded and unsharded runs stay bit-identical
    # through the knife-edge greedy decisions (tests/test_parallel.py)
    s00 = (fA[:, None, :] * t0).sum(-1)                     # [C, c]
    s01 = (fA[:, None, :] * t1).sum(-1)
    s10 = (fB[:, None, :] * t0).sum(-1)
    s11 = (fB[:, None, :] * t1).sum(-1)
    m00, m01, m11 = m_c[..., 0], m_c[..., 1], m_c[..., 2]
    psum = m00 * s00 + m01 * s01 + m01 * s10 + m11 * s11
    psum_safe = jnp.maximum(psum, 1e-37)
    wgt = (B_c[None, :].astype(dt) / psum_safe)             # [C, c]
    w00 = wgt * m00
    w01 = wgt * m01
    w11 = wgt * m11
    dfA = fA * (jnp.einsum("cs,csh->ch", w00, t0, precision=hp)
                + jnp.einsum("cs,csh->ch", w01, t1, precision=hp)) / total_n
    dfB = fB * (jnp.einsum("cs,csh->ch", w01, t0, precision=hp)
                + jnp.einsum("cs,csh->ch", w11, t1, precision=hp)) / total_n
    dll = (B_c[None, :].astype(dt) * jnp.log(psum_safe)).sum(-1)  # [C]
    return dfA, dfB, dll


#: materialize the bool pair mask once (loop-invariant across EM
#: iterations) when S*H*H stays under this; above it, keep a bit-packed
#: copy (8x smaller) while it fits the packed budget, else rematerialize
#: per chunk inside every E-step (trade matmul FLOPs for the quadratic
#: memory wall).  The remat tier repeats the distance matmul chain
#: (c*H^2*2L flops vs the E-step's c*H^2*4C) every iteration, so staying
#: packed matters at cohort scale. These budgets were not measured on the
#: H100.
MASK_MATERIALIZE_ELEMS = 32 * 1024 * 1024
#: default per-classifier packed-mask budget when the caller does not pass
#: one (vmapped trainers multiply this by the classifier batch K)
MASK_PACKED_BUDGET_BYTES = 1280 * 1024 * 1024
#: whole-device packed-mask budget available to a training batch: callers
#: that know their classifier batch size K pass mask_budget =
#: MASK_TOTAL_BUDGET_BYTES // K so small resume batches (K=1..4) can keep
#: multi-GB masks resident instead of falling to the remat tier
#: (HIBAG_TPU_MASK_BUDGET_MB overrides; the rest of the EM working set is
#: chunk-bounded)
MASK_TOTAL_BUDGET_BYTES = int(os.environ.get(
    "HIBAG_TPU_MASK_BUDGET_MB", str(8 * 1024))) * 1024 * 1024


def _em_estep_packed(fA, fB, packed, B, m, total_n):
    """One E+M step from a bit-packed pair mask [S, H, H//8] (cohort-scale
    fast path: the mask is EM-loop-invariant; per chunk a shift/and unpack
    replaces the distance-matmul rematerialization of _em_estep).
    m: [C, S, 3] genotype-selection masks (_geno_sel_masks)."""
    C, H = fA.shape
    dt = fA.dtype
    S = packed.shape[0]
    c, G, pad = _chunk_plan(S, max(H * H, 2 * C * H))
    if G == 1:
        return _em_estep_chunk(fA, fB, _unpack_mask(packed, dt), B, m,
                               total_n)
    packed, B, mT = _pad_samples(pad, packed, B, m.transpose(1, 0, 2))

    def body(carry, xs):
        accA, accB, accL = carry
        p_c, B_c, mT_c = xs
        dfA, dfB, dll = _em_estep_chunk(fA, fB, _unpack_mask(p_c, dt), B_c,
                                        mT_c.transpose(1, 0, 2), total_n)
        return (accA + dfA, accB + dfB, accL + dll), None

    (accA, accB, accL), _ = jax.lax.scan(
        body, (jnp.zeros_like(fA), jnp.zeros_like(fB),
               jnp.zeros(C, fA.dtype)),
        (packed.reshape(G, c, H, H // 8), B.reshape(G, c),
         mT.reshape(G, c, C, 3)))
    return accA, accB, accL


def _em_estep_masked(fA, fB, mask, B, m, total_n):
    """One E+M step with a precomputed pair mask [S, H, H] (the
    small-cohort fast path: the mask is EM-loop-invariant, so computing it
    once outside the while_loop saves a distance matmul per iteration;
    when the caller pre-casts it to the compute dtype, the in-chunk astype
    is a no-op and the cast leaves the loop too).
    m: [C, S, 3] genotype-selection masks (_geno_sel_masks)."""
    C, H = fA.shape
    dt = fA.dtype
    S = mask.shape[0]
    c, G, pad = _chunk_plan(S, max(H * H, 2 * C * H))
    if G == 1:
        return _em_estep_chunk(fA, fB, mask.astype(dt), B, m, total_n)
    mask, B, mT = _pad_samples(pad, mask, B, m.transpose(1, 0, 2))

    def body(carry, xs):
        accA, accB, accL = carry
        mask_c, B_c, mT_c = xs
        dfA, dfB, dll = _em_estep_chunk(fA, fB, mask_c.astype(dt), B_c,
                                        mT_c.transpose(1, 0, 2), total_n)
        return (accA + dfA, accB + dfB, accL + dll), None

    (accA, accB, accL), _ = jax.lax.scan(
        body, (jnp.zeros_like(fA), jnp.zeros_like(fB),
               jnp.zeros(C, fA.dtype)),
        (mask.reshape(G, c, H, H), B.reshape(G, c), mT.reshape(G, c, C, 3)))
    return accA, accB, accL


def _em_estep(fA, fB, bits, valid, allele, geno_sel, a1, a2, B, m,
              total_n):
    """One E+M step over all samples, scanning over sample chunks.

    The matched-pair mask is REMATERIALIZED per chunk from the packed
    haplotype bits (one [chunk·H, L]x[L, H]-shaped distance matmul)
    instead of being carried as a persistent bool[S, H, H] — persistent
    EM state is O(C·H), so cohorts of 10^5 samples fit in device memory
    (the reference streams per-sample pair lists for the same reason,
    src/LibHLA.cpp:1104-1255). m: [C, S, 3] genotype-selection masks."""
    C, H = fA.shape
    dt = fA.dtype
    S = geno_sel.shape[0]
    # mask chunk f32 [c,H,H] and t [2C,c,H] dominate
    c, G, pad = _chunk_plan(S, max(H * H, 2 * C * H))
    if G == 1:
        mask = _match_chunk(bits, valid, allele, geno_sel, a1, a2)
        return _em_estep_chunk(fA, fB, mask.astype(dt), B, m, total_n)
    geno_sel, a1, a2, B, mT = _pad_samples(pad, geno_sel, a1, a2, B,
                                           m.transpose(1, 0, 2))

    def body(carry, xs):
        accA, accB, accL = carry
        gs_c, a1_c, a2_c, B_c, mT_c = xs
        mask_c = _match_chunk(bits, valid, allele, gs_c, a1_c, a2_c)
        dfA, dfB, dll = _em_estep_chunk(fA, fB, mask_c.astype(dt), B_c,
                                        mT_c.transpose(1, 0, 2), total_n)
        return (accA + dfA, accB + dfB, accL + dll), None

    (accA, accB, accL), _ = jax.lax.scan(
        body, (jnp.zeros_like(fA), jnp.zeros_like(fB),
               jnp.zeros(C, fA.dtype)),
        (geno_sel.reshape(G, c, -1), a1.reshape(G, c), a2.reshape(G, c),
         B.reshape(G, c), mT.reshape(G, c, C, 3)))
    return accA, accB, accL


#: default EM convergence reltol — sqrt(machine eps) of the compute dtype,
#: mirroring the reference's sqrt(DBL_EPSILON) scaled to f32 compute
F32_RELTOL = float(np.sqrt(np.finfo(np.float32).eps))

#: EM while-loop body unroll factor (>=1). Unrolling reduces loop-boundary
#: synchronization in the latency-bound small-N regime at the cost of up
#: to (factor-1) discarded E-steps per candidate batch; results are
#: bitwise-independent of the factor (gated selects).
EM_UNROLL = int(os.environ.get("HIBAG_TPU_EM_UNROLL", "1"))


@functools.partial(jax.jit, static_argnames=("reltol", "mask_budget"))
def em_all_candidates(freq0, valid, bits, allele, geno_sel, a1, a2, B,
                      g_new, afreq, total_n, reltol=F32_RELTOL,
                      mask_budget=None):
    """Run the reference's EM to convergence for every candidate SNP.

    freq0 [H]: current haplotype freqs; valid [H] bool; bits [H, L] haplotype
    bit matrix over selected SNPs; allele [H]; geno_sel [S, L] genotype codes
    over the selected SNPs; a1/a2 [S] known HLA alleles (a1 <= a2);
    B [S] bootstrap counts (0 for padded samples); g_new [C, S] candidate-SNP
    genotype codes per in-bag sample; afreq [C] candidate allele freq (from
    PrepareNewSNP); total_n scalar (total sample count).

    The min-Hamming matched-pair set (PrepareHaplotypes) is recomputed per
    sample chunk inside each E-step instead of being materialized as a
    persistent bool[S, H, H] — see _em_estep.

    Convergence mirrors src/LibHLA.cpp:1185-1255: tolerance from the first
    iteration's log-likelihood, |dLL| <= tol, max EM_MAX_ITERATIONS.
    Converged candidates freeze their state while others continue.

    Returns (fA [C,H], fB [C,H], loglik [C], n_iter [C]).
    """
    state = _em_segment_init(freq0, valid, bits, allele, geno_sel, a1, a2,
                             B, g_new, afreq, total_n, reltol=reltol,
                             mask_budget=mask_budget)
    fA, fB, ll, done, it, tol = _em_segment_run(
        freq0, valid, bits, allele, geno_sel, a1, a2, B, g_new, total_n,
        state, jnp.asarray(EM_MAX_ITERATIONS + 1), mask_budget=mask_budget)
    return fA, fB, ll, it


def _make_estep(valid, bits, allele, geno_sel, a1, a2, B, m, total_n,
                dtype, mask_budget=None):
    """The E-step closure with the 3-tier memory strategy (shared by the
    monolithic and segmented EM drivers; the selected tier depends only on
    static shapes, so both trace identically).  mask_budget: bytes
    available for a resident bit-packed pair mask (None = the conservative
    per-classifier default); tiers are bitwise-equivalent — the budget
    only trades device memory for per-iteration distance-matmul
    rematerialization.
    """
    S, H = geno_sel.shape[0], bits.shape[0]
    if mask_budget is None:
        mask_budget = MASK_PACKED_BUDGET_BYTES
    if S * H * H <= MASK_MATERIALIZE_ELEMS:
        mask = match_pairs(bits, valid, allele, geno_sel, a1, a2)
        if S * H * H <= 4 * 1024 * 1024:
            # small problems are while_loop-overhead-bound: pre-cast the
            # mask so the per-iteration astype disappears (the f32 copy is
            # <= 16 MB here; larger sizes keep the 8x-smaller bool)
            mask = mask.astype(dtype)

        def estep(fA, fB):
            return _em_estep_masked(fA, fB, mask, B, m, total_n)
    elif H % 8 == 0 and S * H * (H // 8) <= mask_budget:
        packed = match_pairs_packed(bits, valid, allele, geno_sel, a1, a2)

        def estep(fA, fB):
            return _em_estep_packed(fA, fB, packed, B, m, total_n)
    else:
        def estep(fA, fB):
            return _em_estep(fA, fB, bits, valid, allele, geno_sel, a1, a2,
                             B, m, total_n)
    return estep


@functools.partial(jax.jit, static_argnames=("reltol", "mask_budget"))
def _em_segment_init(freq0, valid, bits, allele, geno_sel, a1, a2, B,
                     g_new, afreq, total_n, reltol=F32_RELTOL,
                     mask_budget=None):
    """Iteration 0 of the EM (DoubleHaplosInitFreq + first E/M step) and
    the first-iteration-anchored tolerance; returns the resumable state
    (fA, fB, ll, done, it, tol)."""
    C = g_new.shape[0]
    v = valid.astype(freq0.dtype)
    # DoubleHaplosInitFreq (src/LibHLA.cpp:447-459): p0*f + eps, p1*f + eps
    fA0 = (freq0[None, :] * (1.0 - afreq[:, None]) + EM_INIT_VAL_FRAC) * v
    fB0 = (freq0[None, :] * afreq[:, None] + EM_INIT_VAL_FRAC) * v
    m = _geno_sel_masks(g_new, freq0.dtype)
    estep = _make_estep(valid, bits, allele, geno_sel, a1, a2, B, m,
                        total_n, freq0.dtype, mask_budget)
    fA1, fB1, ll1 = estep(fA0, fB0)
    tol = reltol * (jnp.abs(ll1) + reltol)
    return fA1, fB1, ll1, jnp.zeros(C, bool), jnp.asarray(1), tol


@functools.partial(jax.jit, static_argnames=("mask_budget",))
def _em_segment_run(freq0, valid, bits, allele, geno_sel, a1, a2, B,
                    g_new, total_n, state, it_end, mask_budget=None):
    """Advance the EM while_loop until convergence, EM_MAX_ITERATIONS, or
    `it_end` (a DYNAMIC scalar: one executable serves any segment length,
    so the host can chain segments, cf. train_fused.fused_grow_segment)."""
    m = _geno_sel_masks(g_new, freq0.dtype)
    estep = _make_estep(valid, bits, allele, geno_sel, a1, a2, B, m,
                        total_n, freq0.dtype, mask_budget)
    tol = state[5]

    def cond(st):
        fA, fB, ll_old, done, it = st
        return (~jnp.all(done)) & (it <= EM_MAX_ITERATIONS) & (it < it_end)

    def one(st):
        fA, fB, ll_old, done, it = st
        fA_new, fB_new, ll = estep(fA, fB)
        newly_done = jnp.abs(ll - ll_old) <= tol
        keep = done[:, None]
        fA = jnp.where(keep, fA, fA_new)
        fB = jnp.where(keep, fB, fB_new)
        ll = jnp.where(done, ll_old, ll)
        return fA, fB, ll, done | newly_done, it + 1

    if EM_UNROLL > 1:
        # unroll the while body: fewer loop-boundary synchronizations for
        # the latency-bound small-N regime. Bitwise-identical to the
        # unrolled=1 loop — every extra sub-iteration is gated by the SAME
        # condition the loop head would have evaluated, so an over-stepped
        # pair is fully discarded (the select keeps the pre-step state).
        def body(st):
            st = one(st)
            for _ in range(EM_UNROLL - 1):
                go = cond(st)
                nxt = one(st)
                st = jax.tree.map(
                    lambda a, b: jnp.where(go, a, b), nxt, st)
            return st
    else:
        body = one

    fA, fB, ll, done, it = jax.lax.while_loop(cond, body, state[:5])
    return fA, fB, ll, done, it, tol


def em_all_candidates_segmented(freq0, valid, bits, allele, geno_sel, a1,
                                a2, B, g_new, afreq, total_n,
                                reltol=F32_RELTOL, iter_seg=32,
                                mask_budget=None):
    """em_all_candidates with at most `iter_seg` EM iterations per device
    dispatch (host-chained segments, state left on device between them).

    Bitwise-identical to the monolithic version — the while_loop state
    trajectory is the same; only the dispatch boundaries differ
    (tests/test_chunked.py::test_em_segmented_matches_monolithic). Bounds
    the length of one device execution at extreme (N, H) scales."""
    state = _em_segment_init(freq0, valid, bits, allele, geno_sel, a1, a2,
                             B, g_new, afreq, total_n, reltol=reltol,
                             mask_budget=mask_budget)
    while True:
        done, it = np.asarray(state[3]), int(state[4])
        if done.all() or it > EM_MAX_ITERATIONS:
            break
        state = _em_segment_run(
            freq0, valid, bits, allele, geno_sel, a1, a2, B, g_new,
            total_n, state, jnp.asarray(it + iter_seg),
            mask_budget=mask_budget)
    fA, fB, ll, done, it, tol = state
    return fA, fB, ll, it


@functools.partial(jax.jit, static_argnames=())
def erase_rare(fA, fB, rare_prob):
    """EraseDoubleHaplos (src/LibHLA.cpp:461-515), vectorized per candidate.

    fA/fB [C, H] (freqs of new-SNP-bit 0/1 versions). For each base
    haplotype: if either member is rare (< rare_prob), keep the single
    higher-frequency member with the merged frequency when the pair sum is
    >= MIN_RARE_FREQ, else drop both; renormalize.

    Returns (fA', fB') with dropped slots exactly 0.
    """
    sumf = fA + fB
    is_rare = (fA < rare_prob) | (fB < rare_prob)
    keep_merged = is_rare & (sumf >= MIN_RARE_FREQ)
    keep_bit0 = fA >= fB  # reference keeps p[0] on ties
    fA2 = jnp.where(is_rare,
                    jnp.where(keep_merged & keep_bit0, sumf, 0.0), fA)
    fB2 = jnp.where(is_rare,
                    jnp.where(keep_merged & ~keep_bit0, sumf, 0.0), fB)
    total = (fA2 + fB2).sum(-1, keepdims=True)
    scale = 1.0 / jnp.maximum(total, 1e-37)
    return fA2 * scale, fB2 * scale


# ---------------------------------------------------------------------------
# candidate evaluation: OOB accuracy + in-bag log-likelihood
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_alleles",))
def evaluate_candidates(bits, allele, new_col, fA, fB, g_cand_eval,
                        geno_sel_eval, true_a1, true_a2, is_oob, B,
                        n_alleles):
    """Score every candidate: OOB best-guess accuracy + in-bag -2logLik.

    bits [H, L] base haplotype bits (selected SNPs in cols 0..n_snp-1);
    allele [H]; new_col (unused: the candidate column factorizes out, kept
    for API stability); fA/fB [C, H] post-erase freqs (0 = dropped);
    g_cand_eval [C, Neval] candidate-SNP genotypes for eval samples;
    geno_sel_eval [Neval, L]; true_a1/true_a2 [Neval] (a1<=a2);
    is_oob [Neval] bool; B [Neval] bootstrap counts (0 for OOB).

    Returns (acc_count [C] int32: per-OOB-sample 0/1/2 summed;
             loglik [C]: -2 sum B*log postprob(true pair)).

    Mirrors _OutOfBagAccuracy / _InBagLogLik (src/LibHLA.cpp:1934-1979), but
    exploits that the doubled list's pairwise distance decomposes as
    D[(i,b1),(j,b2)] = D_base(i,j) + delta(g, b1+b2), so pen = exp(λD)
    factorizes: the expensive [Neval,H,H] penalty matrix is computed ONCE for
    all candidates, and each candidate contributes only 2x2 bilinear-form
    combinations reweighted by q^delta.
    """
    C, H = fA.shape
    Neval = geno_sel_eval.shape[0]
    A = n_alleles
    dt = fA.dtype

    ok = (fA > 0) | (fB > 0)                            # [C, H]
    base_ok = jnp.any(ok, axis=0)                       # [H]
    pair_ok = base_ok[:, None] & base_ok[None, :]
    onehotT = jax.nn.one_hot(allele, A, dtype=dt).T     # [A, H]
    # allele-grouped weights with H minormost (the contraction axis)
    Mf = jnp.stack([fA, fB], axis=1)[:, :, None, :] * onehotT[None, None]
    # Mf: [C, 2, A, H]
    s_grid = jnp.array([[0.0, 1.0], [1.0, 2.0]], dtype=dt)  # b1+b2

    def chunk_fn(geno_c, g_cand_c, a1_c, a2_c, oob_c, B_c):
        n = geno_c.shape[0]
        # shared penalty matrix over base haplotypes (selected SNPs only)
        D = pair_distance(bits, geno_c)                  # [n, H, H]
        Dm = jnp.where(pair_ok[None], D, BIG)
        dmin = jnp.min(Dm, axis=(1, 2), keepdims=True)
        Pen = jnp.exp((LOG_MIN_RARE_FREQ * (Dm - dmin)).astype(dt))
        Pen = jnp.where(pair_ok[None], Pen, 0.0)         # [n, H, H]
        # both contractions keep H minormost on every operand; the
        # [C,n,2,A,H] intermediate replaces [C,n,2,H,A]
        T = jnp.einsum("nij,ceBj->cneBi", Pen, Mf,
                       preferred_element_type=dt,
                       precision=VALUE_PRECISION)            # [C,n,2,A,H]
        Sb = jnp.einsum("cbAi,cneBi->cnbeAB", Mf, T,
                        preferred_element_type=dt,
                        precision=VALUE_PRECISION)
        # candidate-SNP penalty per (b1+b2) given genotype g (hamm_d):
        # g=0: q^s ; g=1: q^{|s-1|} ; g=2: q^{2-s} ; NA: 1
        g = g_cand_c                                     # [C, n]
        delta = jnp.select(
            [g[..., None, None] == 0, g[..., None, None] == 1,
             g[..., None, None] == 2],
            [s_grid[None, None], jnp.abs(s_grid - 1.0)[None, None],
             (2.0 - s_grid)[None, None]],
            jnp.zeros((1, 1, 2, 2), dtype=dt))
        pd = jnp.exp(LOG_MIN_RARE_FREQ * delta)
        S = jnp.einsum("cnbe,cnbeAB->cnAB", pd, Sb,
                       precision=VALUE_PRECISION)        # [C, n, A, A]

        total = S.sum((2, 3))
        # _BestGuess_def weights heterozygous pairs 2*f1*f2 (src/LibHLA.cpp
        # ff = 2*Freq when H1 != H2): double off-diagonal before the argmax
        # so hom-vs-het discrimination matches the reference posterior.
        flat = (S * (2.0 - jnp.eye(A, dtype=S.dtype))[None, None]
                ).reshape(C, n, A * A)
        b = jnp.argmax(flat, axis=2)
        g1, g2 = b // A, b % A
        g1, g2 = jnp.minimum(g1, g2), jnp.maximum(g1, g2)
        # CHLATypeList::Compare (src/LibHLA.cpp:911-924)
        p1, p2, t1, t2 = g1, g2, a1_c[None, :], a2_c[None, :]
        m1 = (p1 == t1) | (p1 == t2)
        t1u = jnp.where(m1 & (p1 == t1), -1, t1)
        t2u = jnp.where(m1 & (p1 != t1) & (p1 == t2), -1, t2)
        m2 = (p2 == t1u) | (p2 == t2u)
        cnt = m1.astype(jnp.int32) + m2.astype(jnp.int32)
        acc_d = jnp.where(oob_c[None] & (total > 0), cnt,
                          0).sum(1).astype(jnp.int32)
        tq = S[:, jnp.arange(n), a1_c, a2_c]
        tq = tq * jnp.where(a1_c == a2_c, 1.0, 2.0)[None].astype(dt)
        post = tq / jnp.maximum(total, 1e-37)
        ll_d = -2.0 * (B_c[None].astype(dt)
                       * jnp.log(jnp.maximum(post, 1e-37))).sum(1)
        return acc_d, ll_d

    # the [C, chunk, 2, H, A] contraction intermediate dominates memory
    c, G, pad = _chunk_plan(Neval, C * 2 * H * A, 8 * 1024 * 1024)
    if G == 1:
        return chunk_fn(geno_sel_eval, g_cand_eval, true_a1, true_a2,
                        is_oob, B)
    geno_sel_eval, gT, true_a1, true_a2, is_oob, B = _pad_samples(
        pad, geno_sel_eval, g_cand_eval.T, true_a1, true_a2, is_oob, B)

    def body(carry, xs):
        acc, ll = carry
        geno_c, gT_c, a1_c, a2_c, oob_c, B_c = xs
        da, dl = chunk_fn(geno_c, gT_c.T, a1_c, a2_c, oob_c, B_c)
        return (acc + da, ll + dl), None

    (accs, lls), _ = jax.lax.scan(
        body, (jnp.zeros(C, jnp.int32), jnp.zeros(C, dt)),
        (geno_sel_eval.reshape(G, c, -1), gT.reshape(G, c, C),
         true_a1.reshape(G, c), true_a2.reshape(G, c),
         is_oob.reshape(G, c), B.reshape(G, c)))
    return accs, lls
