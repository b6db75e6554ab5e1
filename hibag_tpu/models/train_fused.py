"""Fully-fused on-device classifier growth.

The host-loop trainer (train.py) dispatches one device call per greedy step
(~40-60 per classifier), so wall-clock is dominated by dispatch latency.
This module runs the ENTIRE greedy growth — candidate sampling, EM,
rare-haplotype pruning, evaluation, accept/stop/prune decisions, haplotype
list update — inside one jitted ``lax.while_loop``, vmapped over a batch of
classifiers: one device dispatch trains the whole batch.

Differences from the host path (both documented "fast mode" deviations, in
the spirit of the reference's own cluster mode which switches RNG streams):

* Candidate draws use JAX PRNG (Gumbel top-k without replacement over the
  remaining pool) instead of the R Mersenne-Twister replica.
* The haplotype list is kept in fixed slots ordered by descending frequency
  after each accept (the reference keeps allele-grouped insertion order,
  which only affects tie-breaking); if a doubling overflows the slot
  capacity, the lowest-frequency haplotypes are dropped.

Decision logic (running max / tie-break / stop / prune) replicates
CVariableSelection::Search exactly (reference src/LibHLA.cpp:1981-2122).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (FRACTION_HAPLO, GENO_MISSING, MAXNUM_SNP,
                         MIN_RARE_FREQ, PRUNE_RELTOL_LOGLIK,
                         STOP_RELTOL_LOGLIK_ADDSNP)
from .em import em_all_candidates, erase_rare, evaluate_candidates

BIG = 1e9


class GrowState(NamedTuple):
    bits: jax.Array       # [K, Hc, L] f32
    freq: jax.Array       # [K, Hc] f32
    allele: jax.Array     # [K, Hc] i32
    geno_sel: jax.Array   # [K, N, L] i8
    n_snp: jax.Array      # [K] i32
    snp_order: jax.Array  # [K, L] i32 (accepted SNPs in order, -1 pad)
    pool: jax.Array       # [K, P] bool
    gmax_acc: jax.Array   # [K] i32
    gmin_loss: jax.Array  # [K] f32
    done: jax.Array       # [K] bool
    key: jax.Array        # [K, 2] u32
    overflow: jax.Array   # [K] i32 — accepted steps that dropped haplotypes
    n_step: jax.Array     # [K] i32 — live growth steps taken (per classifier)
    steps: jax.Array      # [] i32


def _decide(cand_ok, acc_c, loss_c, gmax_acc, gmin_loss, prune):
    """The reference's running-max candidate scan (src/LibHLA.cpp:2018-2069)
    as a CLOSED-FORM parallel reduction; returns
    (min_i, max_acc, min_loss, kill_mask [Cm]).

    Equivalence to the sequential scan (tested exhaustively against a
    scalar replica in tests/test_fused.py, ties included):
    * the running max is a pure max chase, so the final max_acc is
      max(gmax_acc, max over ok candidates);
    * any candidate with acc == final max sees a running max <= its acc, so
      its loss is always the computed loss_c — the winner is the EARLIEST
      argmin of loss among them (strict-< updates keep the first of equal
      losses), gated on beating gmin_loss when acc did not improve;
    * kills: acc < gmax_acc always kills; acc == gmax_acc kills only when
      no earlier ok candidate exceeded gmax_acc (otherwise the running max
      has moved past it and its loss reads as 0, and the kill threshold
      gmin_loss*(1+PRUNE) is never below 0 since -2logLik >= 0) — a prefix
      OR. The scan's `new_min_i != i` guard is implied: an updater's loss
      is strictly below gmin_loss and so never above the prune threshold.

    Replacing the O(mtry) sequential scalar scan with this reduction
    removes ~mtry dependent steps from every fused growth iteration —
    fixed-cost that dominates at small N where the loop is latency-bound.
    """
    Cm = acc_c.shape[0]
    neg = jnp.int32(np.iinfo(np.int32).min + 1)
    okacc = jnp.where(cand_ok, acc_c, neg)
    max_acc = jnp.maximum(gmax_acc, jnp.max(okacc))
    is_best = cand_ok & (acc_c == max_acc)
    loss_best = jnp.where(is_best, loss_c, jnp.inf)
    wi = jnp.argmin(loss_best).astype(jnp.int32)   # earliest min on ties
    wloss = loss_best[wi]
    has = jnp.any(is_best)
    win = has & ((max_acc > gmax_acc) | (wloss < gmin_loss))
    min_i = jnp.where(win, wi, jnp.int32(-1))
    min_loss = jnp.where(win, wloss, gmin_loss)

    improver = cand_ok & (acc_c > gmax_acc)
    earlier_improver = (jnp.cumsum(improver.astype(jnp.int32))
                        - improver.astype(jnp.int32)) > 0
    kill = cand_ok & ((acc_c < gmax_acc)
                      | ((acc_c == gmax_acc) & ~earlier_improver
                         & (loss_c > gmin_loss
                            * (1 + PRUNE_RELTOL_LOGLIK))))
    kills = jnp.where(prune, kill, jnp.zeros(Cm, bool))
    return min_i, max_acc, min_loss, kills


@functools.partial(
    jax.jit,
    static_argnames=("n_alleles", "mtry", "prune", "freeze",
                     "mask_budget"),
    donate_argnums=(0,))
def fused_grow_segment(state, step_limit, budget, B, real, geno, a1, a2,
                       rare_prob, total_n, n_alleles, mtry,
                       prune=True, freeze=False, mask_budget=None):
    """Advance the fused growth while_loop until every classifier is done
    or ``state.steps`` reaches ``step_limit`` (a dynamic scalar).

    One device dispatch per call; the host driver (fused_grow_batch) chains
    segments so a single XLA execution never runs unboundedly long, and
    segment boundaries are natural checkpoints for progress reports (the
    reference's process farm gets the same property from per-classifier
    job granularity, R/HIBAG.R:293-451).
    State buffers are donated: chaining updates in place on device.

    ``budget`` (dynamic scalar) caps the number of LIVE growth steps each
    classifier may take (``n_step``), so a resumed classifier keeps exactly
    its remaining step allowance.  With ``freeze=True``, a classifier whose
    accepted step would overflow the Hc slot capacity takes NO state update
    at all — not even its PRNG key split — and is marked done with
    overflow=1; the host driver re-seats its state in a larger-capacity
    buffer and resumes, replaying the frozen step identically (the
    fixed-capacity equivalent of the reference's unbounded CHaplotypeList
    growth, src/LibHLA.cpp:461-515).

    Within one capacity bucket the trajectory is fully deterministic.
    Capacity-REPLAY safety (freeze==retry, verified by tests/test_fused.py)
    additionally requires the per-step reductions to group samples
    identically at both capacities: true whenever em._chunk_plan is
    H-independent (the cohort caveat in ``train_fused_batch`` covers the
    rest).
    """
    N, P = geno.shape
    geno_T = geno.T  # [P, N]

    def step_one(state_k, B_k, is_oob_k):
        (bits, freq, allele, geno_sel, n_snp, snp_order, pool,
         gmax_acc, gmin_loss, done, key, overflow, n_step) = state_k
        Hc = bits.shape[0]
        was_done = done

        old_key = key
        key, k1 = jax.random.split(key)
        gumbel = jax.random.gumbel(k1, (P,))
        score = jnp.where(pool, gumbel, -jnp.inf)
        _, cand_idx = jax.lax.top_k(score, mtry)          # [Cm]
        cand_in_pool = jnp.take(pool, cand_idx)

        g_cand = jnp.take(geno_T, cand_idx, axis=0)       # [Cm, N]
        gv = g_cand.astype(jnp.float32)
        okg = (g_cand <= 2)
        allele_cnt = ((jnp.where(okg, gv, 0.0)) @ B_k)
        valid_cnt = 2.0 * (okg.astype(jnp.float32) @ B_k)
        cand_ok = cand_in_pool & (allele_cnt > 0) & (allele_cnt < valid_cnt)
        afreq = jnp.where(cand_ok, allele_cnt / jnp.maximum(valid_cnt, 1.0),
                          0.5)

        valid = freq > 0
        fA, fB, _, _ = em_all_candidates(freq, valid, bits, allele,
                                         geno_sel, a1, a2, B_k, g_cand,
                                         afreq, total_n,
                                         mask_budget=mask_budget)
        fA, fB = erase_rare(fA, fB, rare_prob)
        acc_c, loss_c = evaluate_candidates(bits, allele, n_snp, fA, fB,
                                            g_cand, geno_sel, a1, a2,
                                            is_oob_k, B_k, n_alleles)
        min_i, max_acc, min_loss, kills = _decide(
            cand_ok, acc_c, jnp.asarray(loss_c, jnp.float32),
            gmax_acc, gmin_loss, prune)

        has_cand = min_i >= 0
        sign = jnp.where(
            max_acc > gmax_acc, True,
            jnp.where((max_acc == gmax_acc) & has_cand,
                      (min_loss >= STOP_RELTOL_LOGLIK_ADDSNP)
                      & (min_loss < gmin_loss
                         * (1 - STOP_RELTOL_LOGLIK_ADDSNP)),
                      False))
        sign = sign & ~done
        min_i_safe = jnp.maximum(min_i, 0)
        chosen = cand_idx[min_i_safe]

        # --- accepted-candidate state update (masked by sign) -------------
        fa = fA[min_i_safe]
        fb = fB[min_i_safe]
        bits_a = bits.at[:, n_snp].set(0.0)
        bits_b = bits.at[:, n_snp].set(1.0)
        freq2 = jnp.concatenate([fa, fb])                  # [2Hc]
        bits2 = jnp.concatenate([bits_a, bits_b], axis=0)  # [2Hc, L]
        allele2 = jnp.concatenate([allele, allele])
        order = jnp.argsort(jnp.where(freq2 > 0, -freq2, jnp.inf))[:Hc]
        new_bits = jnp.take(bits2, order, axis=0)
        new_freq = jnp.take(freq2, order)
        new_allele = jnp.take(allele2, order)
        # slot-capacity overflow: live haplotypes beyond Hc get dropped —
        # count it so callers can detect silent model degradation
        dropped = (freq2 > 0).sum() > Hc
        if freeze:
            # freeze-at-first-drop: discard the ENTIRE step (key split
            # included) so the host can re-seat the state at 2x capacity
            # and replay this exact step losslessly; already-done (frozen)
            # classifiers must not advance their key either while their
            # batchmates keep iterating — the resume replays from it
            frozen = sign & dropped
            sign = sign & ~frozen
            key = jnp.where(frozen | was_done, old_key, key)
            overflow = overflow + frozen.astype(jnp.int32)
        else:
            frozen = jnp.zeros((), bool)
            overflow = overflow + jnp.where(sign & dropped, 1, 0)
        new_geno_sel = jax.lax.dynamic_update_index_in_dim(
            geno_sel, jnp.take(geno_T, chosen, axis=0).astype(jnp.int8),
            n_snp, axis=1)

        bits = jnp.where(sign, new_bits, bits)
        freq = jnp.where(sign, new_freq, freq)
        allele = jnp.where(sign, new_allele, allele)
        geno_sel = jnp.where(sign, new_geno_sel, geno_sel)
        snp_order = jnp.where(sign,
                              snp_order.at[n_snp].set(chosen), snp_order)
        n_snp = jnp.where(sign, n_snp + 1, n_snp)
        gmax_acc = jnp.where(sign, max_acc, gmax_acc)
        gmin_loss = jnp.where(sign, min_loss, gmin_loss)

        # --- pool updates -------------------------------------------------
        # accepted: chosen SNP + prune-killed leave the pool
        # rejected: the whole drawn selection leaves the pool
        # frozen: pool untouched — the resumed replay re-draws identically
        kill_scatter = jnp.zeros((P,), bool).at[cand_idx].set(
            jnp.where(sign, kills | (jnp.arange(mtry) == min_i_safe),
                      cand_in_pool))
        pool = jnp.where(done | frozen, pool, pool & ~kill_scatter)

        # a frozen step is replayed on resume, so it does not consume budget
        n_step = n_step + jnp.where(was_done | frozen, 0, 1)
        done = (done | frozen | (~jnp.any(pool)) | (n_snp >= MAXNUM_SNP)
                | (n_step >= budget))
        return (bits, freq, allele, geno_sel, n_snp, snp_order, pool,
                gmax_acc, gmin_loss, done, key, overflow, n_step)

    is_oob = (B == 0) & real[None, :]

    def cond(st: GrowState):
        return (~jnp.all(st.done)) & (st.steps < step_limit)

    def body(st: GrowState):
        out = jax.vmap(step_one)(
            (st.bits, st.freq, st.allele, st.geno_sel,
             st.n_snp, st.snp_order, st.pool, st.gmax_acc,
             st.gmin_loss, st.done, st.key, st.overflow, st.n_step),
            B, is_oob)
        return GrowState(*out, steps=st.steps + 1)

    return jax.lax.while_loop(cond, body, state)


#: growth steps per device dispatch for large cohorts (bounds the wall time
#: of one XLA execution, so progress reports and interrupts come between
#: segments); small cohorts run the whole loop in one dispatch. Not measured
#: on the H100.
SEGMENT_STEPS_LARGE = 8
SEGMENT_SAMPLE_THRESHOLD = 8192
#: on_overflow="retry" keeps doubling hcap up to this ceiling; each bucket
#: costs one compile, and 4096 covers the unbounded reference list at the
#: 10^5-sample scale (the 1e-5 rare floor stops pruning around ~2.5e3
#: haplotypes there — see COVERAGE.md)
RETRY_MAX_HCAP = 4096


def fused_grow_batch(bits0, freq0, allele0, B, real, geno, a1, a2, key0,
                     rare_prob, total_n, n_alleles, mtry, prune=True,
                     max_steps=256, real_snp=None, seg_steps=None,
                     progress=None, freeze=False, state0=None,
                     return_state=False, mask_budget=None):
    """Grow K classifiers on device, in bounded-length dispatch segments.

    bits0/freq0/allele0: [K, Hc, L]/[K, Hc]/[K, Hc] initial singleton
    haplotypes (freq 0 = empty slot); B [K, N] bootstrap counts (0 in padded
    rows); real [N] bool marks genuine samples; geno [N, P] codes;
    a1/a2 [N]; key0 [K] PRNG keys; real_snp [P] bool marks genuine SNP
    columns (bucket-padded columns start outside the candidate pool).
    ``seg_steps``: growth steps per device dispatch (default: all of
    ``max_steps`` for small cohorts, SEGMENT_STEPS_LARGE above
    SEGMENT_SAMPLE_THRESHOLD samples). ``progress``: optional callback
    ``f(steps_done, n_done, K)`` invoked between segments.

    ``freeze``: stop (rather than truncate) classifiers at their first
    slot-capacity overflow — see ``fused_grow_segment``.  ``state0``: a
    ready GrowState to resume from (bits0/freq0/allele0/key0 are then
    ignored; the state is CONSUMED — its buffers are donated to the device
    loop).  ``return_state=True`` returns the final GrowState instead of
    the result tuple (required to re-seat frozen classifiers).

    Returns (bits, freq, allele, n_snp, snp_order, oob_acc_count [K],
    overflow [K]), or the final GrowState when ``return_state``.
    """
    N, P = geno.shape
    if real_snp is None:
        real_snp = jnp.ones((P,), bool)
    if seg_steps is None:
        seg_steps = (max_steps if N <= SEGMENT_SAMPLE_THRESHOLD
                     else SEGMENT_STEPS_LARGE)

    # when the caller sharded the classifier axis over a mesh, place the
    # host-created state arrays with the same K-leading sharding (replicated
    # for the scalar), so the segment jit sees one consistent placement
    putk = putr = lambda x: x
    sharded = False
    try:
        from jax.sharding import NamedSharding, PartitionSpec
        sh = getattr(state0.bits if state0 is not None else bits0,
                     "sharding", None)
        if isinstance(sh, NamedSharding) and sh.mesh.size > 1:
            ens_k = NamedSharding(sh.mesh, PartitionSpec(sh.spec[0]))
            rep = NamedSharding(sh.mesh, PartitionSpec())
            putk = functools.partial(jax.device_put, device=ens_k)
            putr = functools.partial(jax.device_put, device=rep)
            sharded = True
    except Exception:
        pass

    if state0 is not None:
        state = state0
    else:
        K, Hc, L = bits0.shape
        # the segment jit DONATES the state: copy caller-provided leaves so
        # a caller's arrays are never invalidated (a second call with the
        # same key0/bits0 would otherwise hit deleted buffers)
        state = GrowState(
            bits=jnp.array(bits0, copy=True),
            freq=jnp.array(freq0, copy=True),
            allele=jnp.array(allele0, copy=True),
            geno_sel=putk(jnp.full((K, N, L), GENO_MISSING, jnp.int8)),
            n_snp=putk(jnp.zeros(K, jnp.int32)),
            snp_order=putk(jnp.full((K, L), -1, jnp.int32)),
            pool=putk(jnp.tile(jnp.asarray(real_snp)[None, :], (K, 1))),
            gmax_acc=putk(jnp.zeros(K, jnp.int32)),
            gmin_loss=putk(jnp.full(K, 1e30, jnp.float32)),
            done=putk(jnp.zeros(K, bool)),
            key=jnp.array(key0, copy=True),
            overflow=putk(jnp.zeros(K, jnp.int32)),
            n_step=putk(jnp.zeros(K, jnp.int32)),
            steps=putr(jnp.asarray(0, jnp.int32)))
    K = state.done.shape[0]
    if mask_budget is None:
        # divide the chip's packed-pair-mask budget across the vmapped
        # classifier batch: small resume batches at cohort scale keep
        # multi-GB masks resident instead of rematerializing distances
        # every EM iteration (~4-8x per-iteration cost; em.py tiers)
        from .em import (MASK_MATERIALIZE_ELEMS, MASK_PACKED_BUDGET_BYTES,
                         MASK_TOTAL_BUDGET_BYTES)
        mask_budget = MASK_TOTAL_BUDGET_BYTES // max(K, 1)
        if mask_budget < MASK_PACKED_BUDGET_BYTES:
            # the K-divided budget is below the old per-classifier default
            # (K >= 7 at the defaults): if this batch's packed mask would
            # have fit the old budget but not this one, the EM falls from
            # the packed tier to per-chunk remat (~4-8x per-iteration
            # cost) — surface that instead of degrading silently
            H = int(state.bits.shape[1])
            packed_bytes = N * H * (H // 8) if H % 8 == 0 else None
            if (packed_bytes is not None
                    and N * H * H > MASK_MATERIALIZE_ELEMS
                    and mask_budget < packed_bytes
                    <= MASK_PACKED_BUDGET_BYTES):
                import warnings
                warnings.warn(
                    f"EM pair masks ({packed_bytes >> 20} MiB/classifier "
                    f"packed) exceed the K-divided budget "
                    f"({mask_budget >> 20} MiB at K={K}): falling to "
                    f"per-chunk rematerialization (~4-8x per-EM-iteration "
                    f"cost). Train in smaller classifier batches or raise "
                    f"HIBAG_TPU_MASK_BUDGET_MB to keep the packed tier.")
    budget = putr(jnp.asarray(max_steps, jnp.int32))
    steps_done = 0
    while steps_done < max_steps:
        limit = jnp.asarray(min(steps_done + seg_steps, max_steps),
                            jnp.int32)
        state = fused_grow_segment(
            state, limit, budget, B, real, geno, a1, a2, rare_prob,
            total_n, n_alleles, mtry, prune, freeze,
            mask_budget=mask_budget)
        steps_done = int(state.steps)        # syncs once per segment
        done = np.asarray(state.done)
        if progress is not None:
            progress(steps_done, int(done.sum()), K)
        if done.all():
            break
    if return_state:
        return state
    return (state.bits, state.freq, state.allele, state.n_snp,
            state.snp_order, state.gmax_acc, state.overflow)


def _freeze_reseat_impl(state: GrowState, idx, new_hc: int) -> GrowState:
    """Gather the frozen classifiers ``idx`` out of a finished freeze-mode
    state and re-seat them in ``new_hc`` haplotype slots (zero-padded on
    the H axis), cleared for resumption.  One fused device dispatch — the
    state never round-trips to the host (geno_sel alone is ~1.3 GB at
    cohort scale).

    Zero-padding the H axis is lossless: every EM/eval reduction masks
    empty slots by freq>0 and added exact zeros are summation identities,
    and the doubling sort keeps live haplotypes in an identical relative
    order (fa-block indices stay below fb-block indices at any capacity) —
    so the resumed replay is bitwise the step the classifier would have
    taken had it started at ``new_hc`` whenever the eval/EM chunk plans
    are H-independent (verified end-to-end at such shapes by
    tests/test_fused.py::test_fused_overflow_freeze_matches_retry; at
    cohort scale H-dependent chunk plans can flip exact ties — see
    ``train_fused_batch``).
    """
    take = lambda x: jnp.take(x, idx, axis=0)
    kf = idx.shape[0]
    pad = new_hc - state.bits.shape[1]
    return GrowState(
        bits=jnp.pad(take(state.bits), ((0, 0), (0, pad), (0, 0))),
        freq=jnp.pad(take(state.freq), ((0, 0), (0, pad))),
        allele=jnp.pad(take(state.allele), ((0, 0), (0, pad))),
        geno_sel=take(state.geno_sel),
        n_snp=take(state.n_snp),
        snp_order=take(state.snp_order),
        pool=take(state.pool),
        gmax_acc=take(state.gmax_acc),
        gmin_loss=take(state.gmin_loss),
        done=jnp.zeros((kf,), bool),
        key=take(state.key),
        overflow=jnp.zeros((kf,), jnp.int32),
        n_step=take(state.n_step),
        steps=jnp.zeros((), jnp.int32))


#: donating variant (single consumer of the parent state)
_freeze_reseat = functools.partial(
    jax.jit, static_argnames=("new_hc",), donate_argnums=(0,))(
        _freeze_reseat_impl)
#: non-donating variant: used when the parent state feeds MULTIPLE resume
#: chunks (freeze_max_batch), so earlier chunks must not invalidate it
_freeze_reseat_keep = functools.partial(
    jax.jit, static_argnames=("new_hc",))(_freeze_reseat_impl)


def train_fused_batch(ctx, K: int, seed: int, mtry: int, prune: bool = True,
                      hcap: int = 256, first_id: int = 0,
                      max_steps: int = 256, mesh=None,
                      seg_steps=None, progress=None,
                      on_overflow: str = "warn", _ids=None,
                      freeze_max_batch=None) -> list:
    """Train K classifiers with the fused device loop; returns Classifiers.

    With ``mesh`` (a 1-D jax.sharding.Mesh with axis "ens"), the classifier
    axis K of every per-classifier input is sharded across the mesh devices
    and the training data is replicated, so the fused while-loop partitions
    into independent per-device ensembles — the analogue of the
    reference's per-process classifier training (R/HIBAG.R:293-451). K must
    be a multiple of the mesh size.

    ``on_overflow``: what to do when a classifier's doubled haplotype list
    exceeds the ``hcap`` slot capacity (the reference keeps every haplotype,
    so an overflow deviates from exact semantics by dropping the lowest-
    frequency ones). "warn" (default) keeps the truncated classifier;
    "retry" retrains ONLY the overflowed classifiers FROM SCRATCH at
    doubled hcap (identical per-classifier RNG streams, so non-overflowed
    results are unaffected) until clean or hcap reaches RETRY_MAX_HCAP;
    "freeze" NEVER re-runs completed growth steps — overflowed classifiers
    stop at their first dropped haplotype with their PRNG key un-advanced,
    are re-seated on device in an escalated-capacity buffer, and resume
    from the frozen step
    (tests/test_fused.py::test_fused_overflow_freeze_matches_retry).
    Both exact modes cost one compile per hcap bucket; "freeze"
    additionally avoids retraining work.

    Bitwise equivalence scope: "freeze" results equal "retry" results
    bitwise when the eval/EM sample-chunk plans are H-independent (true at
    small/mid shapes, where ``em._chunk_plan`` returns one chunk either
    way).  At cohort scale the chunk plans DEPEND on H, and the two modes
    also visit different capacity schedules (freeze: fine +128/+512 steps;
    retry: 2x doubling), so a resume-at-X trajectory can resolve EXACT
    floating-point ties differently from a from-scratch-at-Y run — the
    same order-defined tie class as docs/DEVIATIONS.md #3 (measured at
    N=102,400: 2/4 classifiers matched the from-scratch run exactly, 2/4
    flipped a tie; COVERAGE.md round-4 caveat).  Both modes keep exact
    LIST semantics (no haplotype is ever dropped below the ceiling).
    """
    from .model import Classifier
    from .train import _init_haplotype
    from ..utils.rng import RRng

    N, P = ctx.n_samp, ctx.n_snp
    L = MAXNUM_SNP
    rare_prob = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    ids = (list(range(first_id, first_id + K)) if _ids is None
           else list(_ids))

    # bootstrap from the R-replica stream (cheap, host), per classifier
    Bs_real = np.stack([RRng((seed + 1000003 * ids[j]) % (2**31 - 1))
                        .bootstrap_counts(N) for j in range(K)])
    Bs = np.stack([ctx.pad_B(b) for b in Bs_real])
    real = np.arange(ctx.n_samp_pad) < N
    bits0 = np.zeros((K, hcap, L), np.float32)
    freq0 = np.zeros((K, hcap), np.float32)
    allele0 = np.zeros((K, hcap), np.int32)
    for k in range(K):
        st = _init_haplotype(ctx, Bs_real[k])
        h = len(st.freq)
        if h > hcap:
            raise ValueError(f"hcap {hcap} < initial haplotypes {h}")
        freq0[k, :h] = st.freq
        allele0[k, :h] = st.allele

    keys = jnp.stack([jax.random.PRNGKey(seed * 7919 + ids[j])
                      for j in range(K)])

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        axis = mesh.axis_names[0]
        ens = NamedSharding(mesh, Pspec(axis))
        rep = NamedSharding(mesh, Pspec())
        put_k = functools.partial(jax.device_put, device=ens)
        put_r = functools.partial(jax.device_put, device=rep)
    else:
        put_k = put_r = jnp.asarray

    real_snp = np.arange(ctx.n_snp_pad) < P

    def _mk(k, bits_k, freq_k, allele_k, ns, snp_order_k, acc_k):
        freq_k = np.asarray(freq_k, dtype=np.float64)
        sel = freq_k > 0
        # order haplotypes by allele for the standard grouped layout
        order = np.argsort(allele_k[sel], kind="stable")
        n_oob = int((Bs_real[k] == 0).sum())
        return Classifier(
            snp_index=snp_order_k[:ns].astype(np.int32),
            hap_bits=bits_k[sel][order][:, :ns].astype(np.uint8),
            hap_freq=freq_k[sel][order],
            hap_allele=allele_k[sel][order].astype(np.int32),
            bootstrap_count=Bs_real[k].astype(np.int32),
            oob_accuracy=float(0.5 * acc_k / max(n_oob, 1)))

    if on_overflow == "freeze":
        return _train_freeze(
            ctx, K, bits0, freq0, allele0, Bs, real, real_snp, keys,
            rare_prob, mtry, prune, hcap, max_steps, mesh, seg_steps,
            progress, put_k, put_r, _mk, freeze_max_batch=freeze_max_batch)

    bits, freq, allele, n_snp, snp_order, acc_cnt, overflow = \
        fused_grow_batch(
            put_k(jnp.asarray(bits0)), put_k(jnp.asarray(freq0)),
            put_k(jnp.asarray(allele0)),
            put_k(jnp.asarray(Bs.astype(np.float32))),
            put_r(jnp.asarray(real)), put_r(ctx.geno_j),
            put_r(ctx.a1_j), put_r(ctx.a2_j), put_k(keys),
            rare_prob, float(N), ctx.n_alleles, mtry, prune, max_steps,
            seg_steps=seg_steps, progress=progress,
            real_snp=put_r(jnp.asarray(real_snp)))
    overflow = np.asarray(overflow)
    retry_map = {}
    if overflow.any():
        if on_overflow == "retry" and hcap < RETRY_MAX_HCAP:
            bad = [k for k in range(K) if overflow[k] > 0]
            retry_ids = [ids[k] for k in bad]
            retry_mesh = mesh
            if mesh is not None:
                # keep the mesh through retries: pad the retry batch to a
                # mesh multiple by duplicating ids (identical RNG streams
                # train identical classifiers; extras are dropped) instead
                # of serializing retry work onto one device
                pad_n = -len(retry_ids) % mesh.size
                if pad_n and pad_n < len(retry_ids):
                    retry_ids = retry_ids + retry_ids[:pad_n]
                elif pad_n:
                    retry_mesh = None
            retrained = train_fused_batch(
                ctx, len(retry_ids), seed, mtry, prune, hcap * 2, 0,
                max_steps, mesh=retry_mesh, seg_steps=seg_steps,
                on_overflow=on_overflow, _ids=retry_ids)
            retry_map = dict(zip(bad, retrained[:len(bad)]))
        else:
            import warnings
            warnings.warn(
                f"hcap={hcap} overflowed on {int((overflow > 0).sum())}/{K} "
                f"classifiers ({int(overflow.sum())} accepted steps dropped "
                f"low-frequency haplotypes); raise hcap (or pass "
                f"on_overflow='freeze') for exact semantics")

    bits = np.asarray(bits)
    freq = np.asarray(freq, dtype=np.float64)
    allele = np.asarray(allele)
    n_snp = np.asarray(n_snp)
    snp_order = np.asarray(snp_order)
    acc_cnt = np.asarray(acc_cnt)
    out = []
    for k in range(K):
        if k in retry_map:
            out.append(retry_map[k])
            continue
        out.append(_mk(k, bits[k], freq[k], allele[k], int(n_snp[k]),
                       snp_order[k], int(acc_cnt[k])))
    return out


def _train_freeze(ctx, K, bits0, freq0, allele0, Bs, real, real_snp, keys,
                  rare_prob, mtry, prune, hcap, max_steps, mesh, seg_steps,
                  progress, put_k, put_r, mk, freeze_max_batch=None):
    """on_overflow="freeze" driver: grow with freeze-at-first-drop, then
    repeatedly re-seat the frozen classifiers at escalated capacity and
    resume them, never re-running a completed growth step.  Equal to
    on_overflow="retry" (which retrains from scratch at 2x hcap) because
    freezing happens at the FIRST drop with the PRNG key un-advanced —
    see ``_freeze_reseat``; bitwise-equal when the eval/EM chunk plans are
    H-independent (see ``train_fused_batch`` for the cohort-scale tie
    caveat).  Equivalent reference behavior: the unbounded haplotype list
    growth in src/LibHLA.cpp:461-515.

    ``freeze_max_batch``: cap on the number of classifiers per resume
    dispatch batch.  At extreme (N, hcap) scales capping the resume batch
    bounds the device memory of each doubled-capacity dispatch while the
    pre-freeze work still runs fully batched at the base hcap.
    """
    import warnings

    N = ctx.n_samp
    Bs_f = Bs.astype(np.float32)
    common = (put_r(jnp.asarray(real)), put_r(ctx.geno_j),
              put_r(ctx.a1_j), put_r(ctx.a2_j))
    grow_kw = dict(seg_steps=seg_steps, progress=progress,
                   real_snp=put_r(jnp.asarray(real_snp)),
                   return_state=True)
    state = fused_grow_batch(
        put_k(jnp.asarray(bits0)), put_k(jnp.asarray(freq0)),
        put_k(jnp.asarray(allele0)), put_k(jnp.asarray(Bs_f)), *common,
        put_k(jnp.asarray(keys)), rare_prob, float(N), ctx.n_alleles,
        mtry, prune, max_steps, freeze=True, **grow_kw)

    results = {}
    # worklist of partially-trained batches: (state, original-index map,
    # current hcap, still-freezing?)
    items = [(state, np.arange(K), hcap, True)]
    while items:
        state, cur, hcap_cur, freezing = items.pop()
        ov = np.asarray(state.overflow)
        fin = np.flatnonzero(ov == 0) if freezing else np.arange(len(ov))
        if fin.size:
            host = [np.asarray(getattr(state, f)) for f in
                    ("bits", "freq", "allele", "n_snp", "snp_order",
                     "gmax_acc")]
            for i in fin:
                k = int(cur[i])
                if k not in results:  # duplicates from bucket padding
                    results[k] = mk(k, host[0][i], host[1][i], host[2][i],
                                    int(host[3][i]), host[4][i],
                                    int(host[5][i]))
        if not freezing:
            if (ov > 0).any():
                warnings.warn(
                    f"hcap={hcap_cur} overflowed on "
                    f"{int((ov > 0).sum())} classifiers at the "
                    f"RETRY_MAX_HCAP ceiling ({int(ov.sum())} accepted "
                    f"steps dropped low-frequency haplotypes)")
            continue
        rows = np.flatnonzero(ov > 0)
        if rows.size == 0:
            continue
        if hcap_cur < RETRY_MAX_HCAP:
            # escalation schedule (capacities stay multiples of 128):
            # double below 512, then +128 steps to 1024, then +512.
            # Rationale (COVERAGE.md N=102,400): cohort-scale overflow
            # happens EARLY (~step 8 of ~40), so nearly all growth runs at
            # the RESUME capacity and per-step cost scales with it — the
            # recorded live peaks (564/558/554; one transient >1024 that
            # fits 1536) sit just above 512, where a doubling jump to
            # 1024/2048 pays 2x per step. Fine steps cost one compile per
            # visited bucket (persistent-cached); re-freezes lose no
            # work. Not re-measured on the H100. Resumed-at-X equals from-scratch-at-X for ANY
            # sufficient X (the capacity invariance the retry-equality
            # test exercises across non-power-of-two jumps).
            if hcap_cur < 512:
                hcap_cur *= 2
            elif hcap_cur < 1024:
                hcap_cur += 128
            else:
                hcap_cur += 512
        else:
            # at the capacity ceiling: finish the frozen classifiers with
            # truncation allowed (same terminal behavior as "retry")
            freezing = False
        cap = freeze_max_batch or rows.size
        chunks = [rows[i:i + cap] for i in range(0, rows.size, cap)]
        for ci, chunk in enumerate(chunks):
            # pad each resume chunk to a power-of-two (and mesh-multiple)
            # bucket by duplicating rows: identical state + RNG trains
            # identical classifiers (extras are dropped above), and
            # bucketed shapes keep the number of compiled (K, hcap)
            # executables small — each fresh shape costs a full compile
            bucket = 1
            while bucket < chunk.size:
                bucket *= 2
            if freeze_max_batch:
                bucket = min(bucket, max(freeze_max_batch, 1))
                bucket = max(bucket, chunk.size)
            if mesh is not None:
                bucket = max(bucket, mesh.size)
                if bucket % mesh.size:
                    bucket *= mesh.size  # mesh.size not a power of two
            if chunk.size != bucket:
                chunk = np.resize(chunk, bucket)
            # donate the parent state only on its final consumer
            reseat = (_freeze_reseat if ci == len(chunks) - 1
                      else _freeze_reseat_keep)
            sub = reseat(state, put_r(jnp.asarray(chunk, jnp.int32)),
                         hcap_cur)
            if mesh is not None:
                sub = GrowState(*(put_k(x) for x in sub[:-1]),
                                steps=put_r(sub.steps))
            sub_cur = cur[chunk]
            sub = fused_grow_batch(
                None, None, None, put_k(jnp.asarray(Bs_f[sub_cur])),
                *common, None, rare_prob, float(N), ctx.n_alleles, mtry,
                prune, max_steps, freeze=freezing, state0=sub, **grow_kw)
            items.append((sub, sub_cur, hcap_cur, freezing))
    return [results[k] for k in range(K)]
