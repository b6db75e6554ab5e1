"""Full 6-locus CI protocol, mirroring the reference's tests/runTests.R:
for each locus, 50/50 stratified split, ±500 kb flanking SNPs, 10-classifier
model, held-out accuracy floors {A:0.9, B:0.8, C:0.8, DQA1:0.8, DQB1:0.8,
DRB1:0.7}.

Run: PYTHONPATH=. python scripts/ci_full.py [n_classifiers] [--mode fused]
--mode selects the trainer (host | fused | auto); fused runs the whole
greedy growth on device, the production path on an accelerator.
"""

import sys
import time

import numpy as np

import hibag_tpu as ht

FLOORS = {"A": 0.9, "B": 0.8, "C": 0.8, "DQA1": 0.8, "DQB1": 0.8, "DRB1": 0.7}


def main(n_classifiers: int = 10, mode: str = "auto") -> int:
    truth = ht.r_to_py(ht.read_rdata(
        "/root/reference/data/HLA_Type_Table.rdata")["HLA_Type_Table"])
    geno = ht.SNPGenoData.from_hibag_r(ht.r_to_py(ht.read_rdata(
        "/root/reference/data/HapMap_CEU_Geno.rdata")["HapMap_CEU_Geno"]))
    failures = 0
    for locus, floor in FLOORS.items():
        t0 = time.time()
        hla = ht.hlaAllele(truth["sample.id"], truth[f"{locus}.1"],
                           truth[f"{locus}.2"], locus=locus, assembly="hg19")
        ids = ht.flanking_snps(geno.snp_id, geno.snp_position, locus,
                               500_000, "hg19")
        fg = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                          ids.astype(str)))
        tr, va = ht.split_alleles(hla, 0.5, np.random.default_rng(100))
        model = ht.train_parallel(tr, fg.subset_by_samples(tr.sample_id),
                                  n_classifiers=n_classifiers, seed=100,
                                  verbose=False, with_matching=False,
                                  mode=mode)
        res = ht.predict(model, fg.subset_by_samples(va.sample_id))
        cmp = ht.compare_alleles(va, res)
        acc = cmp.overall["acc.haplo"]
        ok = acc >= floor
        failures += 0 if ok else 1
        print(f"{locus:>5}: acc.haplo={acc:.4f} floor={floor} "
              f"{'OK' if ok else 'FAIL'} ({time.time() - t0:.1f}s, "
              f"{fg.n_snp} SNPs, {tr.n_samp}/{va.n_samp} split)")
    return failures


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    mode = "auto"
    if "--mode" in args:
        i = args.index("--mode")
        if i + 1 >= len(args):
            sys.exit("usage: ci_full.py [n_classifiers] [--mode "
                     "auto|host|fused]")
        mode = args[i + 1]
        del args[i:i + 2]
    n = int(args[0]) if args else 10
    sys.exit(main(n, mode))
