import os

import numpy as np
import pytest

from hibag_tpu.data.allele import HLATypeTable
from hibag_tpu.data.misc import (check_allele, check_snps, sample_alleles,
                                 summary_geno, summary_model, summary_table)
from hibag_tpu.models.model import AttrBagModel


@pytest.fixture(scope="module")
def model(model_list):
    return AttrBagModel.from_hibag_obj(model_list["A"], locus="A")


def test_check_allele():
    v = check_allele(["A/G", "A/G", "A/G", "A/C", "A/C", "AA/G"],
                     ["A/G", "G/A", "T/C", "G/T", "A/G", "A/G"])
    # A/C vs G/T is valid under strand complement+swap (comp(T)=A, comp(G)=C)
    assert list(v) == [True, True, True, True, False, False]


def test_check_snps(model, hapmap_geno):
    r = check_snps(model, hapmap_geno)
    assert (r["fraction"] == 1.0).all()
    half = hapmap_geno.subset(snp_mask=np.arange(0, hapmap_geno.n_snp, 2))
    r2 = check_snps(model, half)
    assert r2["fraction"].mean() < 1.0


def test_sample_alleles(hla_types, model):
    t = HLATypeTable.from_alleles(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"], locus="A")
    ids = sample_alleles(t, allele_limit=model)
    assert 0 < len(ids) <= t.n_samp


def test_summaries(hapmap_geno, hla_types, model):
    s = summary_geno(hapmap_geno)
    assert f"60 samples X {hapmap_geno.n_snp} SNPs" in s
    t = HLATypeTable.from_alleles(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"], locus="A")
    s2 = summary_table(t)
    assert "# of samples: 60" in s2
    s3 = summary_model(model)
    assert f"individual classifiers: {model.n_classifiers}" in s3


def test_plots(model, hapmap_geno, hla_types, tmp_path):
    from hibag_tpu.eval.plots import (plot_call_rate, plot_ld_heatmap,
                                      plot_matching, plot_model)
    from hibag_tpu.models.introspect import ld_matrix
    from hibag_tpu.models.predict import predict
    res = predict(model, hapmap_geno)
    t = HLATypeTable.from_alleles(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"], locus="A")
    plot_matching(pred=res, out_fn=str(tmp_path / "m.png"))
    plot_call_rate(res, t, n_points=5, out_fn=str(tmp_path / "cr.png"))
    plot_model(model, out_fn=str(tmp_path / "mod.png"))
    r2 = ld_matrix(hapmap_geno.subset(snp_mask=np.arange(30)))
    plot_ld_heatmap(r2, out_fn=str(tmp_path / "ld.png"))
    for f in ("m.png", "cr.png", "mod.png", "ld.png"):
        assert os.path.getsize(tmp_path / f) > 5000


def test_model_save_load_extensionless_path(tmp_path, model_list):
    """save(p)/load(p) must pair for paths without .npz (np.savez appends
    the suffix to bare string paths; the checkpoint writer must not)."""
    from hibag_tpu.models.model import AttrBagModel

    m = AttrBagModel.from_hibag_obj(model_list["A"], locus="A")
    m = m.subset_classifiers(2)
    p = str(tmp_path / "ckpt.model")
    m.save(p)
    assert AttrBagModel.load(p).n_classifiers == 2
