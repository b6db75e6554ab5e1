"""The seeded panel generator that every workload and fixture is built
from."""

import numpy as np
import pytest

from hibag_tpu.data.panel import synthetic_locus


def seeded_panel(n_samples, n_snps, n_alleles, seed, locus="A"):
    return synthetic_locus(locus, n_snps, n_alleles, seed).draw(n_samples,
                                                                seed + 1)


def test_same_seed_same_panel():
    h1, g1 = seeded_panel(50, 80, 10, seed=3)
    h2, g2 = seeded_panel(50, 80, 10, seed=3)
    np.testing.assert_array_equal(g1.genotype, g2.genotype)
    np.testing.assert_array_equal(g1.snp_position, g2.snp_position)
    assert list(h1.allele1) == list(h2.allele1)
    assert list(h1.allele2) == list(h2.allele2)
    _, g3 = seeded_panel(50, 80, 10, seed=4)
    assert not np.array_equal(g1.genotype, g3.genotype)


@pytest.mark.parametrize("locus", ["A", "DRB1"])
def test_panel_shapes_and_positions(locus):
    from hibag_tpu.data.allele import loci_info
    hla, geno = seeded_panel(120, 300, 12, locus=locus, seed=1)
    assert geno.genotype.shape == (300, 120)
    assert geno.genotype.dtype == np.uint8
    assert hla.n_samp == 120 and hla.locus == locus
    assert list(geno.sample_id) == list(hla.sample_id)
    _, start, end, _ = loci_info("hg19")[locus]
    pos = geno.snp_position
    assert np.all(np.diff(pos) > 0)
    assert pos.min() >= start - 500_000 and pos.max() <= end + 500_000
    assert len(set(geno.snp_id)) == 300
    assert set(np.unique(geno.genotype)) <= {0, 1, 2, 3}


def test_error_and_missing_rates():
    pop = synthetic_locus("A", 400, 10, seed=2, error_rate=0.01,
                          missing_rate=0.01)
    _, geno = pop.draw(2000, 5)
    miss = (geno.genotype == 3).mean()
    assert 0.008 < miss < 0.012
    clean = synthetic_locus("A", 400, 10, seed=2, error_rate=0.0,
                            missing_rate=0.0)
    _, g0 = clean.draw(2000, 5)
    assert (g0.genotype == 3).sum() == 0
    # the error and missing draws change about 1% of calls each
    changed = (geno.genotype != g0.genotype).mean()
    assert 0.015 < changed < 0.025


def test_allele_frequencies_are_skewed():
    pop = synthetic_locus("A", 50, 40, seed=0)
    f = pop.allele_freq
    assert np.isclose(f.sum(), 1.0) and np.all(np.diff(f) < 0)
    assert f[0] > 10 * f[-1]
    hla, _ = pop.draw(5000, 1)
    counts = hla.allele_counts()
    assert counts[pop.alleles[0]] > counts.get(pop.alleles[-1], 0)


def test_small_ensemble_reaches_planted_accuracy():
    """A small model trained on one draw types a fresh draw from the same
    population at the reference's CI floor."""
    from hibag_tpu.models.predict import predict
    from hibag_tpu.models.train import train_parallel
    pop = synthetic_locus("A", 120, 8, seed=9)
    hla, geno = pop.draw(150, 1)
    model = train_parallel(hla, geno, n_classifiers=6, batch=6,
                           mode="host", seed=1, verbose=False,
                           with_matching=False)
    thla, tgeno = pop.draw(200, 2)
    res = predict(model, tgeno)
    assert res.accuracy_vs(thla.allele1, thla.allele2) >= 0.9


def test_alleles_of_a_lineage_share_their_background():
    """Alleles of one lineage (same first field) carry the same block
    haplotypes except in a few blocks; alleles of different lineages
    differ in most blocks."""
    from hibag_tpu.data.panel import ALLELE_BLOCKS, ALLELES_PER_LINEAGE
    pop = synthetic_locus("A", 1000, 40, seed=0)
    t = pop.template
    lin = np.arange(40) // ALLELES_PER_LINEAGE
    first = np.array([a.split(":")[0] for a in pop.alleles])
    np.testing.assert_array_equal(first == first[:, None],
                                  lin == lin[:, None])
    diff = (t[:, None, :] != t[None, :, :]).sum(-1)
    same = (lin == lin[:, None]) & ~np.eye(40, dtype=bool)
    assert diff[same].max() <= 2 * ALLELE_BLOCKS
    assert diff[same].min() >= 1
    assert diff[lin != lin[:, None]].min() > t.shape[1] // 2
