"""Reference-parity harness: drive the COMPILED reference kernel and compare
its actual output (classifiers and posteriors) against this framework.

The C++ side is scripts/refbench/parity.cpp — the real CAttrBag_Model built
from /root/reference/src with a bit-exact replica of R's RNG, so training
consumes the identical stream as hibag_tpu.utils.rng.RRng for the same seed
(verified draw-for-draw by `refparity rng`).

Comparisons (each prints one JSON line):

  train   — train classifiers in BOTH engines on identical RNG streams
            (reference target "base": the scalar kernel whose summation
            order defines HIBAG's reproducibility contract) and compare
            bootstrap counts (exact), accepted-SNP sequences (exact),
            haplotype sets (exact), frequencies (<= ~1e-11, f64 path) and
            OOB accuracies (exact).
  predict — inject a model (e.g. the bundled ModelList.RData) into the
            reference kernel via the CAttrBag_Classifier::Assign path
            (reference src/HIBAG.cpp:817-841) and compare per-sample
            posterior vectors, best guesses, max probs and matching.

Greedy-trajectory caveat (measured, see docs/DEVIATIONS.md): on the 60-
sample bundled data, EM distributes frequency symmetrically across
structurally indistinguishable haplotype configurations, so some best-guess
argmaxes are exact floating-point ties. Their resolution depends on the
last ulp of the EM summation order — the reference's own SIMD targets
disagree here (e.g. HLA-A seed 100: the avx512vpopcnt FMA path accepts SNP
229 at step 10 where the scalar "base" path accepts SNP 151). Trajectory
identity is therefore only defined relative to one summation order; this
harness compares against "base" and reports the common prefix when a tie
flip occurs. (locus, seed) pairs used in tests/test_refparity.py are ones
where the full trajectory agrees, making haplotype-set/freq/acc assertions
exact.

Usage:
  python scripts/parity.py train --locus DRB1 --seed 102 --ncls 2
  python scripts/parity.py predict --locus A
  python scripts/parity.py rng
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BUILD = os.environ.get("BUILD", "/tmp/hibag_refbench")
BIN = os.path.join(BUILD, "refparity")


def ensure_built() -> str | None:
    """Build the reference parity driver (cached objects); None on failure."""
    if not os.path.exists(BIN):
        r = subprocess.run(["sh", os.path.join(HERE, "refbench", "build.sh")],
                           capture_output=True, text=True)
        if r.returncode != 0 or not os.path.exists(BIN):
            sys.stderr.write(r.stderr[-2000:] + "\n")
            return None
    return BIN


def _setup_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def locus_setup(locus: str):
    """(ctx, mtry, model-ready hla/geno) with the same QC preamble as both
    engines (the exported data.bin and our trainer see one matrix)."""
    import hibag_tpu as ht
    from hibag_tpu.io.rdata import read_rdata, r_to_py
    from hibag_tpu.models.train import make_training_context, _resolve_mtry

    tt = r_to_py(read_rdata(
        "/root/reference/data/HLA_Type_Table.rdata")["HLA_Type_Table"])
    geno = ht.SNPGenoData.from_hibag_r(r_to_py(read_rdata(
        "/root/reference/data/HapMap_CEU_Geno.rdata")["HapMap_CEU_Geno"]))
    hla = ht.hlaAllele(tt["sample.id"], tt[f"{locus}.1"], tt[f"{locus}.2"],
                      locus=locus, assembly="hg19")
    ids = ht.flanking_snps(geno.snp_id, geno.snp_position, locus,
                           500_000, "hg19")
    fg = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                      ids.astype(str)))
    ctx, alleles, _ = make_training_context(hla, fg)
    return ctx, _resolve_mtry("sqrt", ctx.n_snp), hla, fg, geno


def write_data_bin(ctx, path: str) -> None:
    g = ctx.geno.astype(np.int32)
    g = np.where(g > 2, -1, g)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", ctx.n_samp, ctx.n_snp, ctx.n_alleles))
        f.write(g.astype("<i4").tobytes())
        f.write(ctx.a1.astype("<i4").tobytes())
        f.write(ctx.a2.astype("<i4").tobytes())


def parse_train_dump(path: str) -> list:
    lines = open(path).read().splitlines()
    cls, i = [], 4
    while i < len(lines):
        acc = float(lines[i + 1].split()[1])
        boot = np.array(lines[i + 2].split()[1:], dtype=np.int32)
        snpidx = np.array(lines[i + 3].split()[1:], dtype=np.int32)
        nh = int(lines[i + 4].split()[1])
        hap = [tuple(lines[i + 5 + j].split()) for j in range(nh)]
        cls.append(dict(acc=acc, boot=boot, snpidx=snpidx, hap=hap))
        i += 5 + nh
    return cls


def write_model_dump(model, path: str, n_samp: int = 60) -> None:
    """Serialize an AttrBagModel in the refparity injection format."""
    with open(path, "w") as f:
        f.write(f"n_snp {len(model.snp_id)}\nn_samp {n_samp}\n"
                f"n_hla {model.n_alleles}\n"
                f"n_classifier {model.n_classifiers}\n")
        for k, c in enumerate(model.classifiers):
            f.write(f"classifier {k}\nacc {c.oob_accuracy:.17g}\n")
            f.write(f"nsnp {c.n_snp} "
                    + " ".join(map(str, c.snp_index)) + "\n")
            f.write(f"nhaplo {c.n_haplo}\n")
            for a, fr, bits in zip(c.hap_allele, c.hap_freq, c.hap_bits):
                f.write(f"{a} {fr:.17g} "
                        f"{''.join(str(int(b)) for b in bits)}\n")


def compare_train(locus: str, seed: int, ncls: int,
                  target: str = "base", eval_mode: str = "device") -> dict:
    """Train `ncls` classifiers in both engines on the same RNG stream.

    eval_mode="ordered" scores candidates with the reference's exact
    serial-summation order (native hibag_ordered_eval) so exact floating
    ties in the accept decision resolve identically to target "base"."""
    _setup_jax()
    from hibag_tpu.models.train import grow_classifier
    from hibag_tpu.utils.rng import RRng

    ctx, mtry, *_ = locus_setup(locus)
    data_bin = f"/tmp/parity_{locus}.bin"
    write_data_bin(ctx, data_bin)
    out = f"/tmp/parity_{locus}_{seed}_{target}.txt"
    subprocess.run([BIN, "train", data_bin, str(seed), str(ncls), str(mtry),
                    target, out], check=True, capture_output=True)
    refc = parse_train_dump(out)

    rng = RRng(seed)
    res = {"locus": locus, "seed": seed, "ncls": ncls, "target": target,
           "eval_mode": eval_mode, "classifiers": []}
    for k in range(ncls):
        B = rng.bootstrap_counts(ctx.n_samp)
        c = grow_classifier(ctx, B, rng, mtry, prune=True, dtype=np.float64,
                            eval_mode=eval_mode)
        r = refc[k]
        prefix = 0
        for a, b in zip(r["snpidx"], c.snp_index):
            if a != b:
                break
            prefix += 1
        full = (len(r["snpidx"]) == c.n_snp == prefix)
        entry = {
            "bootstrap_equal": bool(np.array_equal(r["boot"],
                                                   c.bootstrap_count)),
            "ref_n_snp": int(len(r["snpidx"])), "our_n_snp": int(c.n_snp),
            "common_prefix": prefix, "snpidx_equal": bool(full),
        }
        if full:
            rh = [(int(h[0]), h[2]) for h in r["hap"]]
            oh = [(int(a), "".join(map(str, bits)))
                  for a, bits in zip(c.hap_allele, c.hap_bits)]
            entry["hapset_equal"] = rh == oh
            if rh == oh:
                rf = np.array([float(h[1]) for h in r["hap"]])
                entry["freq_max_abs_diff"] = float(
                    np.abs(rf - c.hap_freq).max())
            entry["acc_equal"] = bool(r["acc"] == c.oob_accuracy)
        res["classifiers"].append(entry)
    return res


def compare_predict(locus: str, target: str = "base",
                    missing: float = 0.0, mseed: int = 7,
                    vote: str = "prob") -> dict:
    """Posterior parity on all CEU samples: the bundled published model
    when the locus has one (HLA-A), else a small model trained HERE and
    injected into the reference kernel — which also validates that our
    classifiers round-trip through the reference's Assign path.

    ``missing`` > 0 masks genotypes before BOTH engines see them — a
    ``missing/2`` fraction of whole model SNPs (absent from the array,
    driving the per-classifier weighting path, reference
    src/LibHLA.cpp:2407-2428) plus a scattered ``missing`` fraction of
    individual calls (the in-classifier missing-genotype path)."""
    _setup_jax()
    import hibag_tpu as ht
    from hibag_tpu.io.rdata import read_rdata, r_to_py
    from hibag_tpu.data.geno import align_to_model
    from hibag_tpu.constants import GENO_MISSING

    ml = r_to_py(read_rdata(
        "/root/reference/inst/extdata/ModelList.RData")["modellist"])
    geno = ht.SNPGenoData.from_hibag_r(r_to_py(read_rdata(
        "/root/reference/data/HapMap_CEU_Geno.rdata")["HapMap_CEU_Geno"]))
    if locus in ml:
        model = ht.AttrBagModel.from_hibag_obj(ml[locus], locus=locus)
    else:
        _, _, hla, fg, _ = locus_setup(locus)
        model = ht.train(hla, fg, n_classifiers=4, seed=100, verbose=False,
                         with_matching=False)
    P, A = len(model.snp_id), model.n_alleles

    mdump = f"/tmp/parity_pp_{locus}.txt"
    write_model_dump(model, mdump, n_samp=geno.n_samp)
    codes, _ = align_to_model(model, geno, match_type="Position")
    if missing > 0:
        mrng = np.random.default_rng(mseed)
        codes = codes.copy()                          # [n_samp, P]
        codes[:, mrng.random(P) < missing / 2] = GENO_MISSING
        codes[mrng.random(codes.shape) < missing] = GENO_MISSING
        # our engine consumes the identical masked, model-aligned matrix
        geno = ht.SNPGenoData(
            genotype=codes.T.copy(), sample_id=geno.sample_id,
            snp_id=np.asarray(model.snp_id, dtype=object),
            snp_position=np.asarray(model.snp_position, dtype=np.int64),
            snp_allele=np.asarray(model.snp_allele, dtype=object),
            assembly=geno.assembly)
    gm = codes.astype(np.int32)
    gm[gm >= GENO_MISSING] = -1
    pbin = f"/tmp/parity_pp_{locus}.bin"
    with open(pbin, "wb") as f:
        f.write(struct.pack("<2i", gm.shape[0], P))
        f.write(gm.astype("<i4").tobytes())
    obin = f"/tmp/parity_pp_{locus}_out.bin"
    vm = "2" if vote == "majority" else "1"
    subprocess.run([BIN, "predict", mdump, pbin, vm, obin, target],
                   check=True, capture_output=True)

    raw = open(obin, "rb").read()
    n, nh = struct.unpack("<2i", raw[:8])
    off = 8
    H1 = np.frombuffer(raw, "<i4", n, off); off += 4 * n
    H2 = np.frombuffer(raw, "<i4", n, off); off += 4 * n
    maxp = np.frombuffer(raw, "<f8", n, off); off += 8 * n
    match = np.frombuffer(raw, "<f8", n, off); off += 8 * n
    ntri = A * (A + 1) // 2
    prob = np.frombuffer(raw, "<f8", n * ntri, off).reshape(n, ntri)
    off += 8 * n * ntri
    dosage = np.frombuffer(raw, "<f8", n * A, off).reshape(n, A)

    res = ht.predict(model, geno, vote=vote, dtype=np.float64,
                     with_prob=True,
                     with_dosage=True)
    alleles = np.asarray(model.hla_alleles, dtype=object)
    g1, g2 = alleles[H1], alleles[H2]
    same = int(sum((a == b1 and b == b2) or (a == b2 and b == b1)
                   for a, b, b1, b2 in zip(res.allele1, res.allele2, g1, g2)))
    return {
        "locus": locus, "n_samples": int(n), "missing": missing,
        "vote": vote,
        "n_classifiers": model.n_classifiers, "target": target,
        "postprob_max_abs_diff": float(np.abs(res.postprob.T - prob).max()),
        "maxprob_max_abs_diff": float(np.abs(res.prob - maxp).max()),
        "matching_max_abs_diff": float(np.abs(res.matching - match).max()),
        "dosage_max_abs_diff": float(np.abs(res.dosage.T - dosage).max()),
        "best_guess_identical": same, "best_guess_total": int(n),
    }


def compare_rng(seed: int = 100, n: int = 5000) -> dict:
    """Draw-for-draw stream equality of the C++ R-RNG replica vs RRng."""
    _setup_jax()
    from hibag_tpu.utils.rng import RRng
    out = subprocess.run([BIN, "rng", str(seed), str(n)],
                         capture_output=True, text=True, check=True)
    ref = np.array([float(x) for x in out.stdout.split()])
    ours = RRng(seed).unif_rand(n)
    return {"seed": seed, "n": n,
            "identical": bool(np.array_equal(ref, ours))}


def sweep(loci=("A", "B", "C", "DQA1", "DQB1", "DRB1"),
          seeds=(100, 101, 102),
          ncls: int = 2, target: str = "base",
          eval_mode: str = "device") -> dict:
    """Broad trajectory-parity sweep (the statistic DEVIATIONS.md #3 and
    tests/test_refparity.py cite). Writes docs/PARITY_SWEEP.json (device
    eval) or docs/PARITY_SWEEP_ORDERED.json (eval_mode="ordered")."""
    rows = []
    for locus in loci:
        for seed in seeds:
            r = compare_train(locus, seed, ncls, target, eval_mode)
            for k, c in enumerate(r["classifiers"]):
                rows.append({"locus": locus, "seed": seed, "classifier": k,
                             **c})
            print(json.dumps(rows[-ncls:]), file=sys.stderr, flush=True)
    full = [r for r in rows if r["snpidx_equal"]]
    out = {
        "target": target, "eval_mode": eval_mode, "ncls_per_seed": ncls,
        "n_combos": len(rows),
        "n_full_trajectory_identical": len(full),
        "full_all_hapset_equal": all(r.get("hapset_equal") for r in full),
        "full_all_acc_equal": all(r.get("acc_equal") for r in full),
        "full_max_freq_abs_diff": max(
            (r.get("freq_max_abs_diff", 0.0) for r in full), default=None),
        "prefix_lengths": [r["common_prefix"] for r in rows],
        "rows": rows,
    }
    name = ("PARITY_SWEEP.json" if eval_mode == "device"
            else "PARITY_SWEEP_ORDERED.json")
    path = os.path.join(REPO, "docs", name)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["train", "predict", "rng", "sweep"])
    ap.add_argument("--locus", default="A")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--ncls", type=int, default=2)
    ap.add_argument("--target", default="base")
    ap.add_argument("--missing", type=float, default=0.0)
    ap.add_argument("--vote", default="prob", choices=["prob", "majority"])
    ap.add_argument("--eval", dest="eval_mode", default="device",
                    choices=["device", "ordered"])
    args = ap.parse_args(argv)
    if ensure_built() is None:
        print(json.dumps({"error": "build failed"}))
        return 1
    if args.mode == "train":
        res = compare_train(args.locus, args.seed, args.ncls, args.target,
                            args.eval_mode)
    elif args.mode == "predict":
        res = compare_predict(args.locus, args.target,
                              missing=args.missing, vote=args.vote)
    elif args.mode == "sweep":
        res = dict(sweep(ncls=args.ncls, target=args.target,
                         eval_mode=args.eval_mode))
        res.pop("rows", None)
    else:
        res = compare_rng(args.seed)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
