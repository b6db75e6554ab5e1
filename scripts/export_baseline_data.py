"""Export training sets for the reference-kernel benchmark driver
(scripts/refbench/driver.cpp).

Binary format: int32 n_samp, n_snp, n_hla; int32 geno[n_samp*n_snp]
(sample-major, 0/1/2, missing=-1 -> any out-of-range is treated missing by
the kernel's packing); int32 H1[n_samp]; int32 H2[n_samp].

Usage: python scripts/export_baseline_data.py out.bin [locus] [n_samples]
n_samples > 60 resamples the CEU cohort with replacement.
"""

import struct
import sys

import numpy as np


def export(path: str, locus: str = "A", n_samples: int = 0, seed: int = 0):
    import hibag_tpu as ht
    from hibag_tpu.models.train import make_training_context

    truth = ht.r_to_py(ht.read_rdata(
        "/root/reference/data/HLA_Type_Table.rdata")["HLA_Type_Table"])
    geno = ht.SNPGenoData.from_hibag_r(ht.r_to_py(ht.read_rdata(
        "/root/reference/data/HapMap_CEU_Geno.rdata")["HapMap_CEU_Geno"]))
    if locus.startswith("nearest"):
        # bench.py's config[0] workload: the N SNPs nearest the HLA-A mid
        from hibag_tpu.data.allele import loci_info
        n_near = int(locus.split(":")[1]) if ":" in locus else 1000
        locus = "A"
        _, start, end, _ = loci_info("hg19")[locus]
        mid = (start + end) // 2
        order = np.argsort(np.abs(geno.snp_position - mid))[:n_near]
        fg = geno.subset(snp_mask=np.sort(order))
    else:
        ids = ht.flanking_snps(geno.snp_id, geno.snp_position, locus,
                               500_000, "hg19")
        fg = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                          ids.astype(str)))
    hla = ht.hlaAllele(truth["sample.id"], truth[f"{locus}.1"],
                       truth[f"{locus}.2"], locus=locus, assembly="hg19")
    if n_samples:
        rng = np.random.default_rng(seed)
        tmap = {s: i for i, s in enumerate(hla.sample_id)}
        keep = np.asarray([i for i, s in enumerate(fg.sample_id)
                           if s in tmap])
        fg = fg.subset(samp_mask=keep)
        cols = rng.integers(0, fg.n_samp, n_samples)
        sid = np.array([f"s{i}" for i in range(n_samples)], dtype=object)
        ti = np.array([tmap[s] for s in fg.sample_id])[cols]
        fg = ht.SNPGenoData(
            genotype=fg.genotype[:, cols], sample_id=sid,
            snp_id=fg.snp_id, snp_position=fg.snp_position,
            snp_allele=fg.snp_allele, assembly=fg.assembly)
        hla = ht.hlaAllele(sid, hla.allele1[ti], hla.allele2[ti],
                           locus=locus, assembly="hg19")

    # identical QC/factorization preamble as our own training path, so both
    # kernels see the same matrix
    ctx, alleles, _ = make_training_context(hla, fg)
    g = ctx.geno.astype(np.int32)        # [N, P], 0/1/2, 3=missing
    g = np.where(g > 2, -1, g)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", ctx.n_samp, ctx.n_snp, ctx.n_alleles))
        f.write(g.astype("<i4").tobytes())
        f.write(ctx.a1.astype("<i4").tobytes())
        f.write(ctx.a2.astype("<i4").tobytes())
    print(f"wrote {path}: n_samp={ctx.n_samp} n_snp={ctx.n_snp} "
          f"n_hla={ctx.n_alleles}")


if __name__ == "__main__":
    out = sys.argv[1]
    locus = sys.argv[2] if len(sys.argv) > 2 else "A"
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    export(out, locus, n)
