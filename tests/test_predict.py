"""End-to-end prediction with a model trained on the seeded fixture panel.

The fixture model is a 16-classifier HLA-A model trained on the panel's 60
samples (tests/_panel.py), whose planted types are the truth. The
reference's own CI floor for HLA-A is accuracy >= 0.9 on held-out halves
(reference tests/runTests.R:13-16); a model predicting its own training set
should do at least that well.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def model(model_list):
    from hibag_tpu.models.model import AttrBagModel
    return AttrBagModel.from_hibag_obj(model_list["A"], locus="A")


def test_model_import(model, hapmap_geno, hla_types):
    from _panel import MODEL_CLASSIFIERS
    from hibag_tpu.data.allele import unique_alleles
    assert model.n_classifiers == MODEL_CLASSIFIERS
    # monomorphic SNPs are dropped at training
    assert 0.8 * hapmap_geno.n_snp < model.n_snp <= hapmap_geno.n_snp
    assert model.n_alleles == len(unique_alleles(
        np.concatenate([hla_types["A.1"], hla_types["A.2"]])))
    c = model.classifiers[0]
    assert c.hap_bits.shape[1] == c.n_snp
    assert np.all((c.hap_bits == 0) | (c.hap_bits == 1))
    assert np.all(c.hap_freq > 0)
    # haplotypes grouped by allele index
    assert np.all(np.diff(c.hap_allele) >= 0)
    assert 0 <= c.oob_accuracy <= 1


def test_roundtrip_serialization(model, tmp_path):
    from hibag_tpu.models.model import AttrBagModel
    p = str(tmp_path / "model.npz")
    model.save(p)
    m2 = AttrBagModel.load(p)
    assert m2.n_classifiers == model.n_classifiers
    assert list(m2.hla_alleles) == list(model.hla_alleles)
    c1, c2 = model.classifiers[7], m2.classifiers[7]
    np.testing.assert_array_equal(c1.hap_bits, c2.hap_bits)
    np.testing.assert_allclose(c1.hap_freq, c2.hap_freq)
    np.testing.assert_array_equal(c1.snp_index, c2.snp_index)


def test_hibag_obj_roundtrip(model):
    from hibag_tpu.models.model import AttrBagModel
    obj = model.to_hibag_obj()
    m2 = AttrBagModel.from_hibag_obj(obj, locus="A")
    c1, c2 = model.classifiers[3], m2.classifiers[3]
    np.testing.assert_array_equal(c1.hap_bits, c2.hap_bits)
    np.testing.assert_allclose(c1.hap_freq, c2.hap_freq)


def test_predict_hapmap_accuracy(model, hapmap_geno, hla_types):
    from hibag_tpu.models.predict import predict
    res = predict(model, hapmap_geno, with_prob=True)
    assert res.match_info["n_matched"] == model.n_snp
    # map predictions to truth by sample id
    truth = {s: (a1, a2) for s, a1, a2 in zip(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"])}
    t1 = [truth[s][0] for s in res.sample_id]
    t2 = [truth[s][1] for s in res.sample_id]
    acc = res.accuracy_vs(t1, t2)
    assert acc >= 0.9, f"accuracy {acc} below reference CI floor"
    # probabilities behave
    assert np.all(res.prob > 0) and np.all(res.prob <= 1 + 1e-4)
    assert np.all(res.matching > 0)
    # posterior columns sum to 1
    s = res.postprob.sum(axis=0)
    np.testing.assert_allclose(s, 1.0, atol=1e-4)
    # dosage sums to 2 per sample
    np.testing.assert_allclose(res.dosage.sum(axis=0), 2.0, atol=1e-4)


def test_predict_response_reduction_matches_full(model, hapmap_geno):
    """type="response" reduces best-guess/dosage ON DEVICE (packed [n, A+5]
    pull); its calls, probs, dosage and matching must agree with the full
    posterior-matrix path (with_prob=True pulls [n, A*A+3] and reduces on
    the host). Argmax tie-break order is identical by construction, so the
    calls must match exactly."""
    from hibag_tpu.models.predict import predict

    full = predict(model, hapmap_geno, with_prob=True)
    resp = predict(model, hapmap_geno)                 # response+dosage
    assert list(full.allele1) == list(resp.allele1)
    assert list(full.allele2) == list(resp.allele2)
    np.testing.assert_allclose(resp.prob, full.prob, rtol=1e-6)
    np.testing.assert_allclose(resp.matching, full.matching, rtol=1e-6)
    # device f32 row-sum vs host f64 row-sum of the same matrix
    np.testing.assert_allclose(resp.dosage, full.dosage, rtol=1e-4,
                               atol=1e-6)


def test_pack_memo_invalidates_on_classifier_change(model_list):
    """pack() is memoized; replacing a classifier in place must invalidate
    the memo (a count-only key would return stale ensembles)."""
    from hibag_tpu.models.model import AttrBagModel
    model = AttrBagModel.from_hibag_obj(model_list["A"], locus="A")
    p1 = model.pack()
    assert model.pack() is p1          # memo hit
    model.classifiers = list(model.classifiers)
    model.classifiers[0] = model.classifiers[1]   # same count, new content
    p2 = model.pack()
    assert p2 is not p1
    np.testing.assert_array_equal(p2.hap_freq[0], p2.hap_freq[1])


def test_predict_majority_pallas_matches_scan(model_list, hapmap_geno,
                                             interpret_kernel):
    """Majority voting (reference vote_method=2) asked of the fused kernel
    engine runs the scan engine's per-classifier best guess, so calls,
    vote counts and matching equal engine="jnp" exactly; probability
    voting through the kernel agrees with the scan engine to f32
    tolerance."""
    from hibag_tpu.models.model import AttrBagModel
    from hibag_tpu.models.predict import predict

    model = AttrBagModel.from_hibag_obj(model_list["A"], locus="A")
    a = predict(model, hapmap_geno, vote="majority", engine="jnp",
                with_prob=True)
    b = predict(model, hapmap_geno, vote="majority", engine="triton",
                with_prob=True)
    np.testing.assert_array_equal(a.allele1, b.allele1)
    np.testing.assert_array_equal(a.allele2, b.allele2)
    np.testing.assert_array_equal(a.postprob, b.postprob)
    np.testing.assert_array_equal(a.matching, b.matching)
    a = predict(model, hapmap_geno, engine="jnp", with_prob=True)
    b = predict(model, hapmap_geno, engine="triton", with_prob=True)
    np.testing.assert_array_equal(a.allele1, b.allele1)
    np.testing.assert_array_equal(a.allele2, b.allele2)
    np.testing.assert_allclose(a.postprob, b.postprob, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(a.matching, b.matching, rtol=1e-4)


def test_predict_majority_vote(model, hapmap_geno, hla_types):
    from hibag_tpu.models.predict import predict
    res = predict(model, hapmap_geno, vote="majority")
    truth = {s: (a1, a2) for s, a1, a2 in zip(
        hla_types["sample.id"], hla_types["A.1"], hla_types["A.2"])}
    t1 = [truth[s][0] for s in res.sample_id]
    t2 = [truth[s][1] for s in res.sample_id]
    assert res.accuracy_vs(t1, t2) >= 0.9


def test_predict_with_missing_snps(model, hapmap_geno):
    """Dropping half the SNPs still predicts (classifier weights downweight)."""
    from hibag_tpu.models.predict import predict
    sub = hapmap_geno.subset(snp_mask=np.arange(0, hapmap_geno.n_snp, 2))
    res = predict(model, sub)
    assert res.match_info["n_matched"] < model.n_snp
    assert np.all([a is not None for a in res.allele1])


def test_predict_block_pipeline_equivalence(model, hapmap_geno):
    """Multi-block pipelined prediction (small block, padded tail) must
    match the single-block result exactly — covers the in-flight window,
    the device-side matching reduction, and block-boundary indexing."""
    from hibag_tpu.models.predict import predict

    one = predict(model, hapmap_geno, block=64)     # 60 samples, one block
    many = predict(model, hapmap_geno, block=16)    # 4 blocks, padded tail
    assert list(one.allele1) == list(many.allele1)
    assert list(one.allele2) == list(many.allele2)
    np.testing.assert_allclose(many.prob, one.prob, rtol=1e-6)
    np.testing.assert_allclose(many.matching, one.matching, rtol=1e-5)
    np.testing.assert_allclose(many.dosage, one.dosage, rtol=1e-6,
                               atol=1e-12)
