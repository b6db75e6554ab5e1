import numpy as np
import pytest

from hibag_tpu.data.allele import HLATypeTable
from hibag_tpu.models.introspect import (allele_distance, geno_ld, ld_matrix,
                                         summarize)
from hibag_tpu.models.model import AttrBagModel


@pytest.fixture(scope="module")
def model(model_list):
    return AttrBagModel.from_hibag_obj(model_list["A"], locus="A")


def test_summary(model):
    s = summarize(model)
    from _panel import MODEL_CLASSIFIERS
    assert s["num.classifier"] == MODEL_CLASSIFIERS
    assert 0 < s["num.snp"] <= model.n_snp
    assert s["snp.hist"].sum() == sum(c.n_snp for c in model.classifiers)
    assert 0 <= s["info"]["accuracy"]["Mean"] <= 100


def test_allele_distance(model):
    d = allele_distance(model)
    assert d.shape == (model.n_alleles, model.n_alleles)
    # self-distance is the avg within-allele haplotype divergence: >= 0
    assert np.nanmin(d) >= 0
    np.testing.assert_allclose(d, d.T, equal_nan=True)
    # off-diagonal distances exceed typical diagonal (allele coherence)
    offd = d[~np.eye(len(d), dtype=bool)]
    assert np.nanmean(offd) > np.nanmean(np.diag(d))


def test_geno_ld(hla_types, hapmap_geno):
    t = HLATypeTable.from_alleles(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"], locus="A")
    sub = hapmap_geno.subset(snp_mask=np.arange(50))
    ld = geno_ld(t, sub)
    assert ld.shape == (50,)
    ok = np.isfinite(ld)
    assert ok.sum() > 30
    assert (ld[ok] >= 0).all() and (ld[ok] <= 1 + 1e-9).all()


def test_ld_matrix(hapmap_geno):
    sub = hapmap_geno.subset(snp_mask=np.arange(30))
    r2 = ld_matrix(sub, maf=0.01)
    assert r2.shape[0] == r2.shape[1]
    d = np.diag(r2)
    np.testing.assert_allclose(d[np.isfinite(d)], 1.0, atol=1e-8)
