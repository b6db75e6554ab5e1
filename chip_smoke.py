"""Smoke run of the main path on one NVIDIA GPU: train an ensemble, then
impute a cohort with it through the command line, each checked against
the plain float64 reference.

    python chip_smoke.py           # one card: phases (a)-(f)
    python chip_smoke.py --four    # four cards: the classifier-axis mesh
                                   # against one card, and nothing else

Phases, each printing lines of its own:

(a) set-up: the card's name and power limit, JAX's devices, the native
    library built from the committed sources;
(b) training: ``train_parallel`` of 100 classifiers on a seeded panel of
    1,000 samples x 1,000 SNPs (one per kb over ±500 kb of HLA-A) with
    40 alleles at 256 haplotype slots, with each batch's slot overflows,
    the fused trainer's memory, the peak device memory and the algorithm
    XLA chose for float32 contractions at each precision;
(c) one mid-growth EM + rare-haplotype + candidate-evaluation step in
    float32 against the same step in float64, at a fixed EM iteration count
    and at the production convergence rule;
(d) imputation of a 51,200-sample seeded cohort through
    ``python -m hibag_tpu impute`` (in this process), its accuracy against
    the planted types, and ``predict`` against the float64 scan predictor;
(e) end-to-end ``predict`` of the cohort through the fused kernel and
    through the XLA matmul chain, timed alternately;
(f) one JSON line: {"ok": true, "device": {...}}.

Times printed here are smoke timings of single runs, not benchmarks. Any
failed phase or check ends the run with a non-zero exit code and no JSON
line. The script refuses to run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

SEED = 20240
N_TRAIN, N_SNP, N_ALLELE, N_COHORT = 1000, 1000, 40, 51_200
N_CLASSIFIERS = 100
#: tolerances of the float32 paths against float64 (relative unless named)
TOL_EM_FREQ = 1e-4      # EM frequencies, relative to max(|f64|, 1e-5)
TOL_LOGLIK = 1e-4       # candidate -2 log-likelihood
TOL_POST = 1e-4         # posterior probabilities and dosages, absolute
TOL_MATCH = 1e-4        # matching statistic
#: EM iterations of the fixed-length step check
EM_ITERS = 20


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# (a) set-up
# ---------------------------------------------------------------------------

def setup():
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                 f"{jax.default_backend()!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        log("setup", f"card: {line}")
    devs = jax.devices()
    log("setup", f"jax {jax.__version__}: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run(["make", "-C", os.path.join(here, "native")],
                   capture_output=True, check=True)
    from hibag_tpu.io.native import get_lib
    check(get_lib() is not None, "native library did not load")
    log("setup", "native library built with make -C native and loaded")
    return devs


def panel():
    """The seeded population, its training panel and its cohort."""
    from hibag_tpu.data.panel import synthetic_locus
    pop = synthetic_locus("A", N_SNP, N_ALLELE, seed=SEED)
    hla, geno = pop.draw(N_TRAIN, SEED + 1)
    cohort_hla, cohort = pop.draw(N_COHORT, SEED + 2, id_prefix="c")
    return hla, geno, cohort_hla, cohort


# ---------------------------------------------------------------------------
# (b) training
# ---------------------------------------------------------------------------

def _gemm_settings(hlo_text):
    """The distinct operand precisions and algorithms of the matrix
    products in compiled HLO (cuBLAS calls and XLA's own dots)."""
    prec = re.findall(r'operand_precision":\["?(\w+)', hlo_text) + \
        re.findall(r'operand_precision=\{(\w+)', hlo_text)
    algo = re.findall(r'"algorithm":"(\w+)"', hlo_text) + \
        re.findall(r'algorithm=(\w+)', hlo_text)
    return sorted({f"precision {p}" for p in prec}
                  | {f"algorithm {a}" for a in algo})


def _precision_report():
    """How XLA lowers float32 contractions at each precision: the GEMM
    configuration in the compiled HLO of one E-step chunk, and the error
    of a plain [512, 512] product against float64."""
    import jax
    import jax.numpy as jnp
    from hibag_tpu.models import em

    rng = np.random.default_rng(0)
    a = rng.random((512, 512)).astype(np.float32)
    b = rng.random((512, 512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, p)
        f = jax.jit(lambda x, y: jnp.dot(x, y, precision=prec))
        got = np.asarray(f(a, b), np.float64)
        err = float(np.abs(got - exact).max() / np.abs(exact).max())
        algos = _gemm_settings(f.lower(a, b).compile().as_text())
        log("train", f"float32 dot at Precision.{p}: max rel err "
            f"{err:.2e} vs float64; compiled {algos or 'no GEMM config'}")
    C, c, H = 32, 128, 256
    args = (jnp.asarray(rng.random((C, H)), jnp.float32),
            jnp.asarray(rng.random((C, H)), jnp.float32),
            jnp.asarray(rng.random((c, H, H)) < 0.1, jnp.float32),
            jnp.ones((c,), jnp.float32),
            jnp.ones((C, c, 3), jnp.float32), 1000.0)
    txt = jax.jit(em._em_estep_chunk).lower(*args).compile().as_text()
    prec = _gemm_settings(txt)
    log("train", f"E-step chunk (em.VALUE_PRECISION="
        f"{em.VALUE_PRECISION}) compiled GEMM settings: {prec}")


def train(hla, geno, n_classifiers, dev):
    import jax
    from hibag_tpu.models import train_fused
    from hibag_tpu.models.train import train_parallel

    seen = {}
    orig = train_fused.fused_grow_segment

    def recording(*args, **kw):
        if not seen:
            seen["args"] = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                if isinstance(x, jax.Array) else x, args)
            seen["kw"] = kw
        return orig(*args, **kw)

    train_fused.fused_grow_segment = recording
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            model = train_parallel(hla, geno, n_classifiers=n_classifiers,
                                   batch=25, mode="fused", hcap=256,
                                   with_matching=True, seed=SEED)
        wall = time.perf_counter() - t0
    finally:
        train_fused.fused_grow_segment = orig
    # hcap=256 keeps every batch at one compiled capacity; a classifier
    # whose haplotype list outgrows it drops its rarest haplotypes
    # (on_overflow="warn"), and each batch reports how often
    for w in warned:
        if "overflowed" in str(w.message):
            log("train", f"overflow: {w.message}")
    oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
    log("train", f"{model.n_classifiers} classifiers on {hla.n_samp} "
        f"samples x {model.n_snp} SNPs x {model.n_alleles} alleles: mean "
        f"OOB accuracy {oob:.4f}; {wall:.1f} s wall incl. compile "
        f"(smoke timing, not a benchmark)")
    check(oob > 0.7, f"mean OOB accuracy {oob} <= 0.7")
    ma = orig.lower(*seen["args"], **seen["kw"]).compile().memory_analysis()
    log("train", f"fused_grow_segment memory: args "
        f"{ma.argument_size_in_bytes} B, outputs {ma.output_size_in_bytes}"
        f" B, temps {ma.temp_size_in_bytes} B, code "
        f"{ma.generated_code_size_in_bytes} B")
    log("train", f"peak_bytes_in_use "
        f"{dev.memory_stats()['peak_bytes_in_use']}")
    _precision_report()
    return model


# ---------------------------------------------------------------------------
# (c) one growth step against float64
# ---------------------------------------------------------------------------

def _mid_state(model, hla, geno):
    """A mid-growth state from classifier 0: its haplotypes collapsed onto
    the first half of its SNPs, the next SNP it accepted plus random
    candidates, its bootstrap counts. Returns numpy arrays."""
    from hibag_tpu.constants import FRACTION_HAPLO, MIN_RARE_FREQ
    from hibag_tpu.models.train import make_training_context

    ctx, _, _ = make_training_context(hla, geno)
    c = model.classifiers[0]
    k = max(1, c.n_snp // 2)
    keys, inv = np.unique(np.c_[c.hap_bits[:, :k], c.hap_allele], axis=0,
                          return_inverse=True)
    inv = inv.ravel()
    freq = np.bincount(inv, weights=c.hap_freq)
    H = 256
    check(len(keys) <= H, f"{len(keys)} haplotypes > {H}")
    bits = np.zeros((H, 128), np.float32)
    bits[:len(keys), :k] = keys[:, :k]
    f0 = np.zeros(H)
    f0[:len(keys)] = freq / freq.sum()
    allele = np.zeros(H, np.int32)
    allele[:len(keys)] = keys[:, k]
    model_to_ctx = {s: i for i, s in enumerate(ctx.snp_id)}
    sel = [model_to_ctx[model.snp_id[j]] for j in c.snp_index]
    geno_sel = np.full((ctx.n_samp, 128), 3, np.int8)
    geno_sel[:, :k] = ctx.geno[:, sel[:k]]
    rng = np.random.default_rng(SEED)
    others = rng.choice(np.setdiff1d(np.arange(ctx.n_snp), sel[:k + 1]),
                        31, replace=False)
    cand = np.r_[sel[k:k + 1], others]
    g_new = ctx.geno[:, cand].T.astype(np.int8)              # [32, N]
    B = c.bootstrap_count.astype(np.float64)
    okg = g_new <= 2
    cnt = np.where(okg, g_new, 0) @ B
    afreq = np.clip(cnt / np.maximum(2.0 * (okg @ B), 1.0), 0.0, 1.0)
    N = ctx.n_samp
    rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    return dict(freq0=f0, valid=f0 > 0, bits=bits, allele=allele,
                geno_sel=geno_sel, a1=ctx.a1, a2=ctx.a2, B=B, g_new=g_new,
                afreq=afreq, total_n=float(N), rare=rare, k=k,
                n_alleles=ctx.n_alleles)


def _step(s, dt, fixed):
    """EM + rare-haplotype pruning + candidate evaluation in dtype ``dt``:
    with ``fixed``, exactly EM_ITERS EM iterations; otherwise
    ``em_all_candidates`` with its own convergence rule."""
    import jax.numpy as jnp
    from hibag_tpu.models import em

    f = lambda x: jnp.asarray(x, dt)
    args = (f(s["freq0"]), jnp.asarray(s["valid"]), jnp.asarray(s["bits"]),
            jnp.asarray(s["allele"]), jnp.asarray(s["geno_sel"]),
            jnp.asarray(s["a1"]), jnp.asarray(s["a2"]), f(s["B"]),
            jnp.asarray(s["g_new"]), f(s["afreq"]), s["total_n"])
    if fixed:
        # a negative tolerance never declares convergence
        st = em._em_segment_init(*args, reltol=-1.0)
        fA, fB, _, _, it, _ = em._em_segment_run(
            *args[:9], s["total_n"], st, jnp.asarray(EM_ITERS))
    else:
        fA, fB, _, it = em.em_all_candidates(*args)
    fA, fB = em.erase_rare(fA, fB, s["rare"])
    acc, loss = em.evaluate_candidates(
        jnp.asarray(s["bits"]), jnp.asarray(s["allele"]), s["k"], fA, fB,
        jnp.asarray(s["g_new"]), jnp.asarray(s["geno_sel"]),
        jnp.asarray(s["a1"]), jnp.asarray(s["a2"]),
        jnp.asarray(s["B"] == 0), f(s["B"]), s["n_alleles"])
    acc, loss = np.asarray(acc), np.asarray(loss, np.float64)
    # the candidate a growth step accepts: best OOB accuracy, then the
    # lowest -2logLik, the earliest on ties (train_fused._decide)
    best = np.flatnonzero(acc == acc.max())
    pick = int(best[np.argmin(loss[best])])
    return (np.concatenate([np.asarray(fA, np.float64),
                            np.asarray(fB, np.float64)], 1),
            acc, loss, int(it), pick)


def step_vs_f64(model, hla, geno):
    """The float32 step against float64 twice: at a fixed iteration count,
    which checks the arithmetic, and at the production convergence rule
    (``em.F32_RELTOL`` in both), which reads whether the training
    decision is the same."""
    import jax
    import jax.numpy as jnp
    from hibag_tpu.constants import MIN_RARE_FREQ
    from hibag_tpu.models.em import F32_RELTOL

    s = _mid_state(model, hla, geno)
    for fixed in (True, False):
        f, acc, loss, it, pick = _step(s, jnp.float32, fixed)
        with jax.enable_x64(True):
            f64, acc64, loss64, it64, pick64 = _step(s, jnp.float64, fixed)
        ferr = float((np.abs(f - f64)
                      / np.maximum(np.abs(f64), MIN_RARE_FREQ)).max())
        lerr = float((np.abs(loss - loss64) / np.abs(loss64)).max())
        same = bool(np.array_equal(acc, acc64))
        rule = (f"{EM_ITERS} EM iterations forced" if fixed else
                f"em_all_candidates at reltol {F32_RELTOL:.3g}")
        log("step", f"classifier 0 at {s['k']} SNPs, "
            f"{int(s['valid'].sum())} haplotypes, 32 candidates, {rule}: "
            f"{it}/{it64} iterations (float32/float64); max rel err of EM "
            f"frequencies {ferr:.2e}; OOB accuracy counts identical: "
            f"{same}; max rel err of -2logLik {lerr:.2e}; accepted "
            f"candidate {pick}/{pick64}; float32 contractions at "
            f"Precision.HIGHEST")
        # the fixed-length run is the check; the production rule's run is
        # a reading (each precision stops where its own log-likelihood
        # settles)
        if fixed:
            check(ferr <= TOL_EM_FREQ and lerr <= TOL_LOGLIK and same,
                  f"float32 growth step disagrees with float64 (tol "
                  f"{TOL_EM_FREQ} on frequencies, {TOL_LOGLIK} on -2logLik)")


# ---------------------------------------------------------------------------
# (d) imputation through the CLI
# ---------------------------------------------------------------------------

def impute(model, cohort_hla, cohort, workdir):
    import jax
    from hibag_tpu.cli import main as cli, save_geno
    from hibag_tpu.models.predict import _pair_match, predict

    mpath = os.path.join(workdir, "model.npz")
    gpath = os.path.join(workdir, "cohort.npz")
    model.save(mpath)
    save_geno(cohort, gpath)
    for out in ("calls.vcf", "calls.tsv"):
        t0 = time.perf_counter()
        check(cli(["impute", "--model", mpath, "--geno", gpath, "--out",
                   os.path.join(workdir, out)]) == 0, f"impute -> {out}")
        log("impute", f"python -m hibag_tpu impute: {cohort.n_samp} "
            f"samples -> {out} in {time.perf_counter() - t0:.1f} s "
            f"(smoke timing)")
    with open(os.path.join(workdir, "calls.vcf")) as f:
        rows = [ln for ln in f if not ln.startswith("#")]
    check(len(rows) == model.n_alleles and all(
        len(r.split("\t")) == 9 + cohort.n_samp for r in rows),
        "VCF shape")
    calls = np.loadtxt(os.path.join(workdir, "calls.tsv"), dtype=str,
                       skiprows=1, usecols=(0, 1, 2))
    truth = dict(zip(cohort_hla.sample_id,
                     zip(cohort_hla.allele1, cohort_hla.allele2)))
    acc = float(np.mean([_pair_match(a1, a2, *truth[s]) / 2.0
                         for s, a1, a2 in calls]))
    log("impute", f"accuracy vs planted types {acc:.4f} (floor 0.9)")
    check(acc >= 0.9, f"imputation accuracy {acc} < 0.9")

    sub = cohort.subset(samp_mask=np.arange(2048))
    got = predict(model, sub, with_prob=True)
    with jax.enable_x64(True):
        ref = predict(model, sub, with_prob=True, dtype=np.float64)
    dpost = float(np.abs(got.postprob - ref.postprob).max())
    ddos = float(np.abs(got.dosage - ref.dosage).max())
    dmatch = float((np.abs(got.matching - ref.matching)
                    / ref.matching).max())
    top2 = np.sort(ref.postprob, axis=0)[-2:]
    clear = (top2[1] - top2[0]) >= TOL_POST
    agree = (got.allele1 == ref.allele1) & (got.allele2 == ref.allele2)
    log("impute", f"predict vs float64 scan on 2048 samples: max "
        f"|dposterior| {dpost:.2e}, max |ddosage| {ddos:.2e}, max rel "
        f"|dmatching| {dmatch:.2e} (tol {TOL_POST}); best guess agrees on "
        f"{int(agree[clear].sum())}/{int(clear.sum())} samples without a "
        f"near tie ({int((~clear).sum())} excluded)")
    check(dpost <= TOL_POST and ddos <= 2 * TOL_POST
          and dmatch <= TOL_MATCH and agree[clear].all(),
          "predict disagrees with the float64 reference")


# ---------------------------------------------------------------------------
# (e) the fused kernel against the XLA matmul chain
# ---------------------------------------------------------------------------

def kernel_decision(model, cohort, reps=3):
    from hibag_tpu.models.predict import AUTO_ENGINE, predict

    times = {"triton": [], "jnp": []}
    for eng in times:
        predict(model, cohort, engine=eng)                   # compile
    for _ in range(reps):
        for eng in times:
            t0 = time.perf_counter()
            predict(model, cohort, engine=eng)
            times[eng].append(time.perf_counter() - t0)
    med = {e: float(np.median(t)) for e, t in times.items()}
    win = min(med, key=med.get)
    log("kernel", f"predict {cohort.n_samp} samples x "
        f"{model.n_classifiers} classifiers, median of {reps} alternating "
        f"runs: triton {med['triton']:.3f} s, jnp {med['jnp']:.3f} s "
        f"(all: {times}); faster: {win}; auto on gpu: "
        f"{AUTO_ENGINE['gpu']}")


# ---------------------------------------------------------------------------
# --four: the classifier-axis mesh
# ---------------------------------------------------------------------------

def four(hla, geno, cohort):
    import jax
    from hibag_tpu.models.predict import predict
    from hibag_tpu.models.train import train_parallel
    from hibag_tpu.parallel.mesh import ensemble_mesh

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    kw = dict(n_classifiers=16, batch=16, mode="fused", hcap=256,
              with_matching=False, seed=SEED, verbose=False)
    t0 = time.perf_counter()
    sharded = train_parallel(hla, geno, mesh=ensemble_mesh(devs[:4]), **kw)
    t1 = time.perf_counter()
    with jax.default_device(devs[0]):
        # in batches of the mesh's per-card width, so both runs compile the
        # same per-card program (another batch width may sum in another
        # order and flip exact floating ties, docs/DEVIATIONS.md #3)
        single = train_parallel(hla, geno, **dict(kw, batch=4))
    t2 = time.perf_counter()
    # identical as tests/test_parallel.py asserts on the CPU: the same SNPs
    # and haplotypes, frequencies to float32 reduction order
    same = all(np.array_equal(a.snp_index, b.snp_index)
               and np.array_equal(a.hap_bits, b.hap_bits)
               for a, b in zip(sharded.classifiers, single.classifiers))
    dfreq = max(float(np.abs(a.hap_freq - b.hap_freq).max()) if same
                else np.inf
                for a, b in zip(sharded.classifiers, single.classifiers))
    log("four", f"train_parallel 16 classifiers: 4-GPU mesh {t1 - t0:.1f} "
        f"s, one GPU {t2 - t1:.1f} s (smoke timings); SNPs and haplotypes "
        f"identical: {same}; max |dfreq| {dfreq:.2e}")
    check(same and dfreq <= 1e-5,
          "sharded classifiers differ from single-card ones")
    got = predict(sharded, cohort, devices=devs[:4], with_prob=True)
    with jax.default_device(devs[0]):
        ref = predict(sharded, cohort, with_prob=True)
    dpost = float(np.abs(got.postprob - ref.postprob).max())
    dmatch = float((np.abs(got.matching - ref.matching)
                    / ref.matching).max())
    agree = float(np.mean((got.allele1 == ref.allele1)
                          & (got.allele2 == ref.allele2)))
    log("four", f"predict {cohort.n_samp} samples on 4 GPUs vs one: max "
        f"|dposterior| {dpost:.2e}, max rel |dmatching| {dmatch:.2e} "
        f"(tol {TOL_POST}); best guess agreement {agree:.6f}")
    check(dpost <= TOL_POST and dmatch <= TOL_MATCH,
          "4-GPU predict disagrees with one GPU")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase")
    a = ap.parse_args(argv)
    devs = setup()
    hla, geno, cohort_hla, cohort = panel()
    if a.four:
        four(hla, geno, cohort)
    else:
        model = train(hla, geno, N_CLASSIFIERS, devs[0])
        step_vs_f64(model, hla, geno)
        with tempfile.TemporaryDirectory() as wd:
            impute(model, cohort_hla, cohort, wd)
        kernel_decision(model, cohort)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
