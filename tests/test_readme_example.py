"""The README quick-start, executed against the seeded fixture panel
(which stands in for the BED file the README reads)."""

import numpy as np


def test_quickstart_flow(tmp_path, hla_types, hapmap_geno):
    import hibag_tpu as ht

    geno = hapmap_geno
    hla = ht.HLATypeTable.from_alleles(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"],
        locus="A", assembly="hg19")

    ids = ht.flanking_snps(geno.snp_id, geno.snp_position, "A", 500_000,
                           "hg19")
    geno = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                        ids.astype(str)))

    model = ht.train_parallel(hla, geno, n_classifiers=4, batch=4, seed=100,
                              verbose=False, with_matching=False)
    model.save(str(tmp_path / "hla_A.npz"))

    res = ht.predict(model, geno, with_prob=True)
    assert len(res.allele1) == geno.n_samp

    cmp = ht.compare_alleles(hla, res)
    assert cmp.overall["acc.haplo"] > 0.8
    md = ht.report(cmp, "markdown")
    assert md.startswith("**")
    ht.write_vcf(res, str(tmp_path / "imputed.vcf.gz"))

    sub = hla.subset_by_samples(res.sample_id)
    r = ht.assoc_test(sub, np.arange(sub.n_samp) % 2, model="additive")
    assert "table" in r
    # probe: wrong-length phenotype fails loudly
    try:
        ht.assoc_test(sub, np.arange(sub.n_samp + 5) % 2)
        assert False, "length mismatch not caught"
    except ValueError:
        pass

    m2 = ht.AttrBagModel.load(str(tmp_path / "hla_A.npz"))
    assert m2.n_classifiers == model.n_classifiers
