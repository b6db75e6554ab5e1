"""Attribute-bagging training: bootstrap, greedy SNP selection, EM.

Host-side orchestration of the device kernels in em.py, replicating the
reference's control flow (CVariableSelection::Search, src/LibHLA.cpp:
1981-2122; CAttrBag_Model::BuildClassifiers, src/LibHLA.cpp:2268-2305;
hlaAttrBagging wrapper, R/HIBAG.R:48-275), with one structural change made
for the hardware: all mtry candidate SNPs are EM-fitted and scored *in
parallel on device* per greedy step (they are independent given the shared
pair masks), instead of the reference's serial per-candidate loop.

Decision logic (accept / tie-break / stop / prune) follows the reference
exactly, including its running-max evaluation-order semantics and its RNG
consumption order (bootstrap before selection; partial Fisher-Yates draws).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (FRACTION_HAPLO, GENO_MISSING, MAXNUM_SNP,
                         MIN_RARE_FREQ, PRUNE_RELTOL_LOGLIK,
                         STOP_RELTOL_LOGLIK_ADDSNP)
from ..data.allele import unique_alleles
from ..utils.rng import RRng
from .em import (em_all_candidates, em_all_candidates_segmented,
                 erase_rare, evaluate_candidates)
from .model import AttrBagModel, Classifier


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SamplingWithoutReplace:
    """Index-pool bookkeeping, mirroring CSamplingWithoutReplace
    (src/LibHLA.cpp:930-993) including RNG consumption order."""

    def __init__(self, m_total: int):
        self.idx = list(range(m_total))
        self.m_try = 0

    def total(self) -> int:
        return len(self.idx)

    def random_select(self, m_try: int, rng: RRng) -> None:
        n = len(self.idx)
        if m_try > n:
            m_try = n
        if m_try < n:
            for i in range(m_try):
                k = rng.random_num(n - i)
                self.idx[k], self.idx[n - i - 1] = self.idx[n - i - 1], self.idx[k]
        self.m_try = m_try

    def selection(self) -> list:
        return self.idx[len(self.idx) - self.m_try:]

    def set_selected(self, i: int, value: int) -> None:
        self.idx[len(self.idx) - self.m_try + i] = value

    def remove(self, i: int) -> None:
        del self.idx[len(self.idx) - self.m_try + i]

    def remove_selection(self) -> None:
        del self.idx[len(self.idx) - self.m_try:]

    def remove_flagged(self) -> None:
        n = len(self.idx)
        for i in range(n - 1, n - self.m_try - 1, -1):
            if self.idx[i] < 0:
                del self.idx[i]


@dataclass
class TrainingContext:
    """Shared per-locus training data (device-resident constants)."""

    geno: np.ndarray          # [N, P] codes {0,1,2,3}
    a1: np.ndarray            # [N] int32 allele index, a1 <= a2
    a2: np.ndarray            # [N]
    n_alleles: int
    snp_id: np.ndarray
    snp_position: np.ndarray
    snp_allele: np.ndarray
    sample_id: np.ndarray
    hap_bucket: int = 32

    def __post_init__(self):
        self.n_samp, self.n_snp = self.geno.shape
        # pad the sample axis to a shape BUCKET (powers of two and their
        # 1.5x midpoints, >= 64): padded rows are all-missing with zero
        # bootstrap weight, so EM/eval sums are unchanged
        # (tests/test_chunked.py), and nearby cohort sizes share compiled
        # executables of the fused path
        self.n_samp_pad = _shape_bucket(self.n_samp)
        pad = self.n_samp_pad - self.n_samp
        # SNP axis likewise bucketed for the fused trainer's static shapes;
        # padded columns are all-missing and start outside the candidate
        # pool, so they are never drawn (host paths only index real columns)
        self.n_snp_pad = _shape_bucket(self.n_snp)
        snp_pad = self.n_snp_pad - self.n_snp
        self.geno_pad = np.pad(self.geno, ((0, pad), (0, snp_pad)),
                               constant_values=GENO_MISSING)
        self.geno_j = jnp.asarray(self.geno_pad)
        self.a1_j = jnp.asarray(np.pad(self.a1, (0, pad)))
        self.a2_j = jnp.asarray(np.pad(self.a2, (0, pad)))

    def pad_B(self, B: np.ndarray) -> np.ndarray:
        return np.pad(B, (0, self.n_samp_pad - self.n_samp))


def _shape_bucket(n: int, lo: int = 64) -> int:
    """Next bucket >= n from {64, 96, 128, 192, 256, 384, ...} (powers of
    two and their 1.5x midpoints; multiples of 8192 above that) — bounds
    padding waste at 33% (16% at biobank scale) while collapsing nearby
    shapes onto shared compiled executables."""
    if n > 16384:
        return _round_up(n, 8192)
    b = lo
    while b < n:
        b = b + b // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


@dataclass
class _HaploState:
    """Host-side current haplotype list (allele-grouped, compact)."""

    bits: np.ndarray     # [H, n_snp] uint8
    freq: np.ndarray     # [H] float64
    allele: np.ndarray   # [H] int32 nondecreasing


#: diagnostic hook: set to a list to record (cands, ok, acc, loss) per step
_TRACE = None


def _init_haplotype(ctx: TrainingContext, B: np.ndarray) -> _HaploState:
    """Freq-weighted singleton haplotype per observed allele
    (_InitHaplotype, src/LibHLA.cpp:1880-1914)."""
    counts = np.zeros(ctx.n_alleles, dtype=np.int64)
    np.add.at(counts, ctx.a1, B)
    np.add.at(counts, ctx.a2, B)
    # counts sums to 2*SumCnt (each sample contributes both alleles); the
    # reference scales by 0.5/SumCnt so init freqs sum to 1 — scaling by
    # 0.5/counts.sum() (an old bug) halved them, which EM convergence
    # mostly washed out (~5e-12 residual vs the reference kernel) but the
    # exact scale reaches ~5e-16 (measured, scripts/parity.py)
    total = counts.sum()
    sel = np.nonzero(counts > 0)[0]
    return _HaploState(
        bits=np.zeros((len(sel), 0), dtype=np.uint8),
        freq=counts[sel] * (1.0 / total),
        allele=sel.astype(np.int32),
    )


def grow_classifier(ctx: TrainingContext, B: np.ndarray, rng: RRng,
                    mtry: int, prune: bool = True,
                    verbose_detail: bool = False,
                    dtype=np.float32,
                    em_iter_seg: Optional[int] = None,
                    eval_mode: str = "device") -> Classifier:
    """Grow one classifier: greedy forward SNP selection
    (CVariableSelection::Search, src/LibHLA.cpp:1981-2122).

    dtype: device compute dtype for EM/eval (np.float64 gives the opt-in
    reference-precision path; requires jax_enable_x64 — used to quantify
    the f32 decision deviation, see docs/DEVIATIONS.md #1).
    em_iter_seg: EM iterations per device dispatch (None = the whole EM in
    one dispatch). Bounds the length of one device execution at extreme
    (N, haplotype-count) scales — results are bitwise identical either
    way.
    eval_mode: "device" (production) scores candidates with the factorized
    device kernel; "ordered" (parity mode, needs the native lib) scores them
    with the reference's EXACT serial summation order so that exact
    floating ties in the accept decision resolve identically to the
    compiled reference kernel (_BestGuess_def/_PostProb_def traversal,
    src/LibHLA.cpp:1428-1560; serial in-bag sum src/LibHLA.cpp:1964-1977).
    Decisions can differ from "device" only at those ties — see
    docs/DEVIATIONS.md #3 and tests/test_refparity.py.
    """
    N, P = ctx.n_samp, ctx.n_snp
    Np = ctx.n_samp_pad
    L = MAXNUM_SNP
    n_oob = int((B == 0).sum())
    rare_prob = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    B_pad = ctx.pad_B(B.astype(dtype))
    Bj = jnp.asarray(B_pad)
    is_oob_j = jnp.asarray((B_pad == 0)
                           & (np.arange(Np) < N))

    state = _init_haplotype(ctx, B)
    snp_sel: list[int] = []
    geno_sel = np.full((Np, L), GENO_MISSING, dtype=np.int8)
    geno_sel_j = jnp.asarray(geno_sel)

    sampling = SamplingWithoutReplace(P)
    global_max_acc = 0      # correct allele count over OOB
    global_min_loss = 1e30

    while sampling.total() > 0 and len(snp_sel) < MAXNUM_SNP:
        H = len(state.freq)
        Hcap = _round_up(max(H, 1), ctx.hap_bucket)
        bits_p = np.zeros((Hcap, L), dtype=np.float32)
        if state.bits.size:
            bits_p[:H, :state.bits.shape[1]] = state.bits
        freq_p = np.zeros(Hcap, dtype=dtype)
        freq_p[:H] = state.freq
        allele_p = np.zeros(Hcap, dtype=np.int32)
        allele_p[:H] = state.allele
        bits_j = jnp.asarray(bits_p)
        freq_j = jnp.asarray(freq_p)
        valid_j = jnp.asarray(freq_p > 0)
        allele_j = jnp.asarray(allele_p)

        sampling.random_select(mtry, rng)
        cands = sampling.selection()
        Cm = len(cands)
        # pad the candidate batch to a fixed width so kernel shapes (and
        # compiled executables) are stable when the pool shrinks below mtry
        cand_idx = np.zeros(mtry, dtype=np.int64)
        cand_idx[:Cm] = cands

        # PrepareNewSNP: bootstrap-weighted allele freq, monomorphic filter
        g_cand = ctx.geno_pad[:, cand_idx].T.astype(np.int8)   # [Cm, Np]
        gv = g_cand.astype(np.int64)
        ok = gv <= 2
        allele_cnt = np.where(ok, gv, 0) @ B_pad.astype(np.int64)
        valid_cnt = 2 * (ok @ B_pad.astype(np.int64))
        cand_ok = (allele_cnt > 0) & (allele_cnt < valid_cnt)
        cand_ok[Cm:] = False
        afreq = np.where(cand_ok, allele_cnt / np.maximum(valid_cnt, 1), 0.5)

        if eval_mode == "ordered":
            # parity mode: the WHOLE candidate step (EM, erase, eval) runs
            # in the native ordered-reduction replica so exact floating
            # ties resolve as the reference's scalar "base" target does
            from ..io.native import ordered_step
            res = ordered_step(
                state.bits, state.freq, state.allele, g_cand[:, :N],
                geno_sel[:N], ctx.a1, ctx.a2, (B == 0),
                B.astype(np.float64), ctx.n_alleles, float(N), rare_prob)
            if res is None:
                raise RuntimeError(
                    "eval_mode='ordered' requires the native library "
                    "(make -C native)")
            _, fA, fB, acc_c, loss_c = res
            loss_c = loss_c.astype(np.float64)
        else:
            # EM for all candidates at once (pair matching fused into the
            # E-step chunk scan), then rare-haplotype pruning
            em_fn = em_all_candidates if em_iter_seg is None else \
                functools.partial(em_all_candidates_segmented,
                                  iter_seg=em_iter_seg)
            fA, fB, _, _ = em_fn(
                freq_j, valid_j, bits_j, allele_j, geno_sel_j, ctx.a1_j,
                ctx.a2_j, Bj, jnp.asarray(g_cand),
                jnp.asarray(afreq.astype(dtype)), float(N),
                reltol=float(np.sqrt(np.finfo(dtype).eps)))
            fA, fB = erase_rare(fA, fB, rare_prob)

            # evaluate OOB accuracy + in-bag log-lik for all candidates
            new_col = jnp.asarray(len(snp_sel), dtype=jnp.int32)
            acc_c, loss_c = evaluate_candidates(
                bits_j, allele_j, new_col, fA, fB, jnp.asarray(g_cand),
                geno_sel_j, ctx.a1_j, ctx.a2_j, is_oob_j, Bj,
                ctx.n_alleles)
            acc_c = np.asarray(acc_c)
            loss_c = np.asarray(loss_c, dtype=np.float64)
        if _TRACE is not None:
            _TRACE.append((list(cands), cand_ok.copy(), acc_c.copy(),
                           loss_c.copy()))

        # --- reference decision scan (running-max semantics) -------------
        max_acc = global_max_acc
        min_loss = global_min_loss
        min_i = -1
        for i in range(Cm):
            if not cand_ok[i]:
                continue
            acc = int(acc_c[i])
            loss = float(loss_c[i]) if acc >= max_acc else 0.0
            if acc > max_acc:
                min_i, min_loss, max_acc = i, loss, acc
            elif acc == max_acc and loss < min_loss:
                min_i, min_loss = i, loss
            if prune:
                if acc < global_max_acc:
                    sampling.set_selected(i, -1)
                elif acc == global_max_acc:
                    if loss > global_min_loss * (1 + PRUNE_RELTOL_LOGLIK) \
                            and min_i != i:
                        sampling.set_selected(i, -1)

        if max_acc > global_max_acc:
            sign = True
        elif max_acc == global_max_acc and min_i >= 0:
            sign = (min_loss >= STOP_RELTOL_LOGLIK_ADDSNP and
                    min_loss < global_min_loss * (1 - STOP_RELTOL_LOGLIK_ADDSNP))
        else:
            sign = False

        if sign:
            global_max_acc = max_acc
            global_min_loss = min_loss
            chosen_snp = cands[min_i]
            fa = np.asarray(fA[min_i], dtype=np.float64)[:Hcap]
            fb = np.asarray(fB[min_i], dtype=np.float64)[:Hcap]
            # flatten doubled list (interleaved 2h+b keeps allele grouping)
            n_old = len(snp_sel)
            keep0 = fa[:H] > 0
            keep1 = fb[:H] > 0
            new_bits, new_freq, new_allele = [], [], []
            for h in range(H):
                base = state.bits[h] if n_old else np.zeros(0, np.uint8)
                if keep0[h]:
                    new_bits.append(np.append(base, 0).astype(np.uint8))
                    new_freq.append(fa[h])
                    new_allele.append(state.allele[h])
                if keep1[h]:
                    new_bits.append(np.append(base, 1).astype(np.uint8))
                    new_freq.append(fb[h])
                    new_allele.append(state.allele[h])
            state = _HaploState(
                bits=np.asarray(new_bits, dtype=np.uint8),
                freq=np.asarray(new_freq, dtype=np.float64),
                allele=np.asarray(new_allele, dtype=np.int32))
            snp_sel.append(int(chosen_snp))
            geno_sel[:, n_old] = ctx.geno_pad[:, chosen_snp]
            geno_sel_j = jnp.asarray(geno_sel)
            if prune:
                sampling.set_selected(min_i, -1)
                sampling.remove_flagged()
            else:
                sampling.remove(min_i)
            if verbose_detail:
                print(f"    {len(snp_sel):2d}, SNP: {chosen_snp + 1}, "
                      f"loss: {global_min_loss:g}, "
                      f"oob acc: {50.0 * global_max_acc / max(n_oob, 1):.2f}%, "
                      f"# of haplo: {len(state.freq)}")
        else:
            sampling.remove_selection()

    oob_acc = 0.5 * global_max_acc / max(n_oob, 1)
    return Classifier(
        snp_index=np.asarray(snp_sel, dtype=np.int32),
        hap_bits=state.bits,
        hap_freq=state.freq,
        hap_allele=state.allele,
        bootstrap_count=B.astype(np.int32),
        oob_accuracy=float(oob_acc),
    )


def train_parallel_batch(ctx: TrainingContext, rngs: list, mtry: int,
                         prune: bool = True, mesh=None,
                         verbose: bool = False) -> list:
    """Grow K classifiers in lockstep, batching device work per greedy step.

    The device replacement for the reference's process-parallel ensemble
    training (hlaParallelAttrBagging, R/HIBAG.R:293-451): every greedy step
    runs `batched_grow_step` over the classifier axis — sharded across the
    mesh when one is given — while the host applies each classifier's
    accept/stop/prune decisions independently. Classifiers that finish early
    ride along as no-ops until the batch drains. Each classifier consumes
    its own RNG stream (the reference's cluster mode likewise switches to
    per-worker L'Ecuyer streams).
    """
    from ..parallel.mesh import batched_grow_step
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    K = len(rngs)
    N, Pn = ctx.n_samp, ctx.n_snp
    Np = ctx.n_samp_pad
    L = MAXNUM_SNP
    rare_prob = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)

    Bs_real = np.stack([r.bootstrap_counts(N) for r in rngs])   # [K, N]
    Bs = np.stack([ctx.pad_B(b) for b in Bs_real])              # [K, Np]
    states = [_init_haplotype(ctx, Bs_real[k]) for k in range(K)]
    snp_sels: list[list[int]] = [[] for _ in range(K)]
    geno_sel = np.full((K, Np, L), GENO_MISSING, dtype=np.int8)
    samplings = [SamplingWithoutReplace(Pn) for _ in range(K)]
    gmax_acc = [0] * K
    gmin_loss = [1e30] * K
    done = [False] * K
    n_oob = (Bs_real == 0).sum(1)
    real_row = np.arange(Np) < N
    is_oob_arr = (Bs == 0) & real_row[None, :]

    shard = None
    if mesh is not None:
        shard = NamedSharding(mesh, P("ens"))

    def put(x):
        a = jnp.asarray(x)
        return jax.device_put(a, shard) if shard is not None else a

    while not all(done):
        Hs = [len(s.freq) for s in states]
        Hcap = _round_up(max(Hs), ctx.hap_bucket)
        bits = np.zeros((K, Hcap, L), dtype=np.float32)
        freq = np.zeros((K, Hcap), dtype=np.float32)
        allele = np.zeros((K, Hcap), dtype=np.int32)
        for k, s in enumerate(states):
            bits[k, :Hs[k], :s.bits.shape[1]] = s.bits
            freq[k, :Hs[k]] = s.freq
            allele[k, :Hs[k]] = s.allele

        cands_k: list[list] = []
        cand_idx = np.zeros((K, mtry), dtype=np.int64)
        for k in range(K):
            if done[k]:
                cands_k.append([])
                continue
            samplings[k].random_select(mtry, rngs[k])
            c = samplings[k].selection()
            cands_k.append(c)
            cand_idx[k, :len(c)] = c

        g_cand = np.take(ctx.geno_pad, cand_idx, axis=1)    # [Np, K, Cm]
        g_cand = np.moveaxis(g_cand, 0, 2).astype(np.int8)  # [K, Cm, N]
        gv = g_cand.astype(np.int64)
        okg = gv <= 2
        allele_cnt = np.einsum("kcn,kn->kc", np.where(okg, gv, 0), Bs)
        valid_cnt = 2 * np.einsum("kcn,kn->kc", okg, Bs)
        cand_ok = (allele_cnt > 0) & (allele_cnt < valid_cnt)
        for k in range(K):
            cand_ok[k, len(cands_k[k]):] = False
        afreq = np.where(cand_ok, allele_cnt / np.maximum(valid_cnt, 1), 0.5)
        new_col = np.array([len(s) for s in snp_sels], dtype=np.int32)

        fA, fB, acc_b, loss_b = batched_grow_step(
            put(bits), put(freq), put(allele), put(geno_sel),
            put(Bs.astype(np.float32)), put(is_oob_arr), put(g_cand),
            put(afreq.astype(np.float32)), put(new_col),
            ctx.a1_j, ctx.a2_j,
            rare_prob, float(N), ctx.n_alleles)
        fA = np.asarray(fA, dtype=np.float64)
        fB = np.asarray(fB, dtype=np.float64)
        acc_b = np.asarray(acc_b)
        loss_b = np.asarray(loss_b, dtype=np.float64)

        for k in range(K):
            if done[k]:
                continue
            cands = cands_k[k]
            max_acc, min_loss, min_i = gmax_acc[k], gmin_loss[k], -1
            for i in range(len(cands)):
                if not cand_ok[k, i]:
                    continue
                acc = int(acc_b[k, i])
                loss = float(loss_b[k, i]) if acc >= max_acc else 0.0
                if acc > max_acc:
                    min_i, min_loss, max_acc = i, loss, acc
                elif acc == max_acc and loss < min_loss:
                    min_i, min_loss = i, loss
                if prune:
                    if acc < gmax_acc[k]:
                        samplings[k].set_selected(i, -1)
                    elif acc == gmax_acc[k]:
                        if loss > gmin_loss[k] * (1 + PRUNE_RELTOL_LOGLIK) \
                                and min_i != i:
                            samplings[k].set_selected(i, -1)

            if max_acc > gmax_acc[k]:
                sign = True
            elif max_acc == gmax_acc[k] and min_i >= 0:
                sign = (min_loss >= STOP_RELTOL_LOGLIK_ADDSNP and
                        min_loss < gmin_loss[k] * (1 - STOP_RELTOL_LOGLIK_ADDSNP))
            else:
                sign = False

            if sign:
                gmax_acc[k], gmin_loss[k] = max_acc, min_loss
                st = states[k]
                H = Hs[k]
                fa, fb = fA[k, min_i, :H], fB[k, min_i, :H]
                n_old = len(snp_sels[k])
                new_bits, new_freq, new_allele = [], [], []
                for h in range(H):
                    base = st.bits[h] if n_old else np.zeros(0, np.uint8)
                    if fa[h] > 0:
                        new_bits.append(np.append(base, 0).astype(np.uint8))
                        new_freq.append(fa[h])
                        new_allele.append(st.allele[h])
                    if fb[h] > 0:
                        new_bits.append(np.append(base, 1).astype(np.uint8))
                        new_freq.append(fb[h])
                        new_allele.append(st.allele[h])
                states[k] = _HaploState(
                    bits=np.asarray(new_bits, dtype=np.uint8),
                    freq=np.asarray(new_freq, dtype=np.float64),
                    allele=np.asarray(new_allele, dtype=np.int32))
                chosen = cands[min_i]
                snp_sels[k].append(int(chosen))
                geno_sel[k, :, n_old] = ctx.geno_pad[:, chosen]
                if prune:
                    samplings[k].set_selected(min_i, -1)
                    samplings[k].remove_flagged()
                else:
                    samplings[k].remove(min_i)
            else:
                samplings[k].remove_selection()

            if samplings[k].total() == 0 or len(snp_sels[k]) >= MAXNUM_SNP:
                done[k] = True

    out = []
    for k in range(K):
        out.append(Classifier(
            snp_index=np.asarray(snp_sels[k], dtype=np.int32),
            hap_bits=states[k].bits,
            hap_freq=states[k].freq,
            hap_allele=states[k].allele,
            bootstrap_count=Bs_real[k].astype(np.int32),
            oob_accuracy=float(0.5 * gmax_acc[k] / max(int(n_oob[k]), 1)),
        ))
    return out


def train_parallel(hla_table, geno_data, n_classifiers: int = 100,
                   mtry="sqrt", prune: bool = True, seed: int = 100,
                   batch: Optional[int] = None, mesh=None,
                   na_rm: bool = True, mono_rm: bool = True,
                   maf: float = float("nan"), verbose: bool = True,
                   with_matching: bool = True, hap_bucket: int = 64,
                   auto_save: Optional[str] = None,
                   first_id: int = 0, mode: str = "auto",
                   hcap: int = 256, max_steps: int = 256,
                   on_overflow: str = "warn", seg_steps: Optional[int] = None,
                   freeze_max_batch: Optional[int] = None,
                   resume: bool = False) -> AttrBagModel:
    """Parallel ensemble training (hlaParallelAttrBagging equivalent).

    Trains classifiers in device-batched groups of `batch` (default: one per
    mesh device, or 8). With `auto_save`, writes the partial model after
    every batch — the reference's incremental-checkpoint behavior
    (R/HIBAG.R:359-422). With `resume=True` and an existing `auto_save`
    file, training continues from the saved partial ensemble (same
    per-classifier RNG substreams, so the completed model is identical to
    an uninterrupted run) — an extension beyond the reference, which only
    writes checkpoints.

    seg_steps (fused mode): growth steps per device dispatch. Default
    bounds single-dispatch wall time automatically; a smaller value gives
    more frequent progress reports at extreme (N, hcap) scales.
    """
    import os as _os
    import jax
    ctx, alleles, _ = make_training_context(
        hla_table, geno_data, na_rm=na_rm, mono_rm=mono_rm, maf=maf,
        hap_bucket=hap_bucket)
    m = _resolve_mtry(mtry, ctx.n_snp)
    if mode == "auto":
        # fused mode wins on accelerators at every validated scale (2x the
        # host loop even at N=2000/P=4000; host dispatch counts are
        # prohibitive beyond that). Cohort-scale dispatches are segmented
        # (train_fused.SEGMENT_STEPS_LARGE), so single-execution wall time
        # stays bounded at any N. On CPU the one-dispatch advantage is moot
        # and compiles are pure overhead.
        mode = "fused" if jax.default_backend() != "cpu" else "host"
    if batch is None:
        batch = len(mesh.devices.flat) if mesh is not None \
            else min(8, max(1, len(jax.devices())))

    classifiers: list = []
    k0 = first_id
    if resume and auto_save and _os.path.exists(auto_save):
        prev = AttrBagModel.load(auto_save)
        classifiers = list(prev.classifiers)[:n_classifiers]
        k0 = first_id + len(classifiers)
        if verbose and classifiers:
            print(f"-- resuming from {auto_save}: "
                  f"{len(classifiers)}/{n_classifiers} classifiers")
    model = None
    while len(classifiers) < n_classifiers:
        kb = min(batch, n_classifiers - len(classifiers))
        t0 = time.time()
        if mode == "fused":
            from .train_fused import (SEGMENT_SAMPLE_THRESHOLD,
                                      train_fused_batch)
            prog = None
            if verbose and ctx.n_samp_pad > SEGMENT_SAMPLE_THRESHOLD:
                def prog(steps, ndone, K, _t0=time.time()):
                    print(f"   fused growth: step {steps}, {ndone}/{K} "
                          f"classifiers done [{time.time() - _t0:.1f}s]",
                          flush=True)
            cls = train_fused_batch(ctx, kb, seed=seed, mtry=m, prune=prune,
                                    hcap=hcap, first_id=k0,
                                    max_steps=max_steps, mesh=mesh,
                                    seg_steps=seg_steps, progress=prog,
                                    on_overflow=on_overflow,
                                    freeze_max_batch=freeze_max_batch)
        else:
            rngs = [RRng((seed + 1000003 * (k0 + j)) % (2**31 - 1))
                    for j in range(kb)]
            cls = train_parallel_batch(ctx, rngs, m, prune=prune, mesh=mesh)
        classifiers.extend(cls)
        k0 += kb
        if verbose:
            oob = np.mean([c.oob_accuracy for c in cls])
            print(f"-- #{len(classifiers)}, batch of {kb} in "
                  f"{time.time() - t0:.2f}s, avg oob acc: {oob * 100:.2f}%")
        if auto_save:
            _partial_model(ctx, alleles, hla_table, geno_data,
                           classifiers).save(auto_save)

    model = _partial_model(ctx, alleles, hla_table, geno_data, classifiers)
    if with_matching:
        from .predict import predict
        pd = predict(model, geno_data, match_type="Pos+Allele")
        model.matching = pd.matching
        if auto_save:
            model.save(auto_save)
    return model


def train_distributed(hla_table, geno_data, n_classifiers: int = 100,
                      seed: int = 100, coordinator: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      **kwargs) -> AttrBagModel:
    """Multi-host ensemble training over the JAX distributed runtime.

    Each host trains a deterministic contiguous share of the ensemble on its
    local devices (identical RNG substreams regardless of topology, so a
    1-host and an N-host run produce the same classifiers), then classifier
    parameter blocks are all-gathered and every host returns the full
    merged model. Single-process: equivalent to train_parallel.

    Replaces hlaParallelAttrBagging's PSOCK-cluster job farm
    (reference R/HIBAG.R:293-451, R/DataUtilities.R:124-213).
    """
    from ..parallel.mesh import (classifier_range, distributed_init,
                                 gather_classifiers)
    pi, pc = distributed_init(coordinator, num_processes, process_id)
    rng_range = classifier_range(n_classifiers, pi, pc)
    local = train_parallel(
        hla_table, geno_data, n_classifiers=len(rng_range), seed=seed,
        first_id=rng_range.start, with_matching=False, **kwargs)
    model = gather_classifiers(local, n_classifiers)
    return model


def train_dynamic(hla_table, geno_data, n_classifiers: int = 100,
                  seed: int = 100, work_dir: Optional[str] = None,
                  job_size: int = 8, coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  **kwargs) -> AttrBagModel:
    """Dynamic load-balanced multi-host ensemble training (opt-in).

    The greedy-refill counterpart of ``train_distributed``'s deterministic
    static split — the reference's ``.DynamicClusterCall`` job farm
    (R/DataUtilities.R:124-213), where the master hands the next job to
    whichever worker finishes first so a straggler or late-joining host
    never idles the rest.  Here each worker CLAIMS the next ``job_size``-
    classifier batch by atomically creating a claim file in ``work_dir``
    (O_CREAT|O_EXCL — must be a filesystem shared by all hosts), trains
    it, and repeats until no unclaimed batches remain; classifier blocks
    then all-gather.

    Although WHICH host trains a batch is nondeterministic, the RESULT is
    not: per-classifier RNG substreams are id-derived (seed + 1000003*id),
    so the merged ensemble is bit-identical to the static split and to a
    single-process run regardless of placement
    (tests/test_parallel.py::test_train_dynamic_two_processes_straggler).

    kwargs pass through to train_parallel (mode, hcap, on_overflow, ...).
    """
    import os
    import tempfile
    from ..parallel.mesh import allgather_pickled, distributed_init

    pi, pc = distributed_init(coordinator, num_processes, process_id)
    if work_dir is None:
        if pc > 1:
            raise ValueError("train_dynamic with multiple processes needs "
                             "a shared work_dir for the claim files")
        work_dir = tempfile.mkdtemp(prefix="hibag_dyn_")
    os.makedirs(work_dir, exist_ok=True)

    starts = list(range(0, n_classifiers, job_size))
    local: dict = {}
    for ci, lo in enumerate(starts):
        try:
            fd = os.open(os.path.join(work_dir, f"claim_{ci}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue  # another worker got there first
        os.write(fd, str(pi).encode())
        os.close(fd)
        hi = min(lo + job_size, n_classifiers)
        part = train_parallel(hla_table, geno_data, n_classifiers=hi - lo,
                              seed=seed, first_id=lo, with_matching=False,
                              **kwargs)
        for off, c in enumerate(part.classifiers):
            local[lo + off] = c

    if pc > 1:
        merged: dict = {}
        for part_map in allgather_pickled(local):
            merged.update(part_map)
    else:
        merged = local
    if len(merged) != n_classifiers:
        raise RuntimeError(
            f"dynamic schedule finished with {len(merged)}/{n_classifiers} "
            f"classifiers — stale claim files in {work_dir}?")

    ctx, alleles, _ = make_training_context(hla_table, geno_data)
    return _partial_model(ctx, alleles, hla_table, geno_data,
                          [merged[k] for k in range(n_classifiers)])


def _partial_model(ctx, alleles, hla_table, geno_data, classifiers):
    g = ctx.geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        afreq = (np.where(miss, 0, g).sum(0)
                 / np.maximum(2.0 * (~miss).sum(0), 1))
    hla_freq = np.zeros(len(alleles))
    for a in (ctx.a1, ctx.a2):
        np.add.at(hla_freq, a, 1)
    hla_freq /= max(hla_freq.sum(), 1)
    return AttrBagModel(
        locus=hla_table.locus,
        snp_id=ctx.snp_id, snp_position=ctx.snp_position,
        snp_allele=ctx.snp_allele, snp_allele_freq=afreq,
        hla_alleles=list(alleles), hla_freq=hla_freq,
        assembly=geno_data.assembly, sample_id=ctx.sample_id,
        classifiers=list(classifiers))


def make_training_context(hla_table, geno_data, na_rm: bool = True,
                          mono_rm: bool = True, maf: float = float("nan"),
                          hap_bucket: int = 32) -> tuple:
    """Sample intersection / SNP QC / allele factorization
    (hlaAttrBagging preamble, R/HIBAG.R:77-174).

    Returns (TrainingContext, allele_list, kept_snp_mask).
    """
    # common samples, preserving hla-table order of the intersection
    geno_pos = {s: i for i, s in enumerate(geno_data.sample_id)}
    keep = [i for i, s in enumerate(hla_table.sample_id) if s in geno_pos]
    if na_rm:
        keep = [i for i in keep
                if hla_table.allele1[i] is not None
                and hla_table.allele2[i] is not None]
    if not keep:
        raise ValueError("no common samples between HLA table and genotypes")
    samp_ids = hla_table.sample_id[keep]
    h1 = hla_table.allele1[keep]
    h2 = hla_table.allele2[keep]
    gcols = np.array([geno_pos[s] for s in samp_ids])
    geno = geno_data.genotype[:, gcols].T.copy()   # [N, P]

    # SNP filtering (monomorphic / MAF)
    g = geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        f = np.where(miss, 0, g).sum(0) / np.maximum(2.0 * (~miss).sum(0), 1)
    mf = np.minimum(f, 1 - f)
    mf[~np.isfinite(mf)] = 0
    snp_keep = np.ones(geno.shape[1], dtype=bool)
    if mono_rm:
        snp_keep &= mf > 0
    if np.isfinite(maf):
        snp_keep &= mf >= maf
    geno = geno[:, snp_keep]

    alleles = unique_alleles(np.concatenate([h1, h2]))
    aidx = {a: i for i, a in enumerate(alleles)}
    a1 = np.array([aidx[a] for a in h1], dtype=np.int32)
    a2 = np.array([aidx[a] for a in h2], dtype=np.int32)
    a1, a2 = np.minimum(a1, a2), np.maximum(a1, a2)

    ctx = TrainingContext(
        geno=geno.astype(np.int8), a1=a1, a2=a2, n_alleles=len(alleles),
        snp_id=geno_data.snp_id[snp_keep],
        snp_position=geno_data.snp_position[snp_keep],
        snp_allele=geno_data.snp_allele[snp_keep],
        sample_id=samp_ids, hap_bucket=hap_bucket)
    return ctx, alleles, snp_keep


def _resolve_mtry(mtry, n_snp: int) -> int:
    """mtry resolution (R/HIBAG.R:180-208)."""
    if isinstance(mtry, str):
        if mtry == "sqrt":
            m = int(np.ceil(np.sqrt(n_snp)))
        elif mtry == "all":
            m = n_snp
        elif mtry == "one":
            m = 1
        else:
            raise ValueError(f"invalid mtry {mtry!r}")
    else:
        m = float(mtry)
        if not np.isfinite(m):
            m = int(np.ceil(np.sqrt(n_snp)))
        else:
            if 0 < m < 1:
                m = n_snp * m
            m = min(int(np.ceil(m)), n_snp)
    return max(int(m), 1)


def train(hla_table, geno_data, n_classifiers: int = 100, mtry="sqrt",
          prune: bool = True, na_rm: bool = True, mono_rm: bool = True,
          maf: float = float("nan"), seed: Optional[int] = None,
          rng: Optional[RRng] = None, verbose: bool = True,
          verbose_detail: bool = False, with_matching: bool = True,
          hap_bucket: int = 32,
          assembly: Optional[str] = None,
          dtype=np.float32,
          em_iter_seg: Optional[int] = None) -> AttrBagModel:
    """Build an attribute-bagging model (hlaAttrBagging equivalent,
    reference R/HIBAG.R:48-275).

    dtype: EM/eval compute precision (np.float64 = reference-precision
    opt-in; needs jax_enable_x64)."""
    ctx, alleles, _ = make_training_context(
        hla_table, geno_data, na_rm=na_rm, mono_rm=mono_rm, maf=maf,
        hap_bucket=hap_bucket)
    m = _resolve_mtry(mtry, ctx.n_snp)
    if rng is None:
        rng = RRng(seed)
    if verbose:
        print(f"Build a model with {n_classifiers} individual classifiers:")
        print(f"    # of SNPs randomly sampled as candidates "
              f"for each selection: {m}")
        print(f"    # of SNPs: {ctx.n_snp}")
        print(f"    # of samples: {ctx.n_samp}")
        print(f"    # of unique HLA alleles: {ctx.n_alleles}")

    classifiers = []
    for k in range(n_classifiers):
        t0 = time.time()
        B = rng.bootstrap_counts(ctx.n_samp)
        c = grow_classifier(ctx, B, rng, m, prune=prune,
                            verbose_detail=verbose_detail, dtype=dtype,
                            em_iter_seg=em_iter_seg)
        classifiers.append(c)
        if verbose:
            print(f"[{k + 1}] {time.strftime('%Y-%m-%d %H:%M:%S')}, "
                  f"oob acc: {c.oob_accuracy * 100:.2f}%, "
                  f"# of SNPs: {c.n_snp}, # of haplo: {c.n_haplo} "
                  f"({time.time() - t0:.2f}s)")

    # model SNP set = SNPs used by any classifier? No — the reference keeps
    # the full filtered SNP set (pruning to used SNPs is hlaPublish's job).
    model = _partial_model(ctx, alleles, hla_table, geno_data, classifiers)
    if assembly:
        model.assembly = assembly

    if with_matching:
        from .predict import predict
        pd = predict(model, geno_data, match_type="Pos+Allele")
        model.matching = pd.matching
        if verbose:
            oob = np.mean([c.oob_accuracy for c in classifiers])
            print(f"Out-of-bag accuracy: {oob * 100:.2f}%")
    return model
