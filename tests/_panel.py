"""The seeded fixture panel, shared by conftest.py and the worker scripts
of the multi-process tests."""

import pathlib

#: root of the checkout (worker processes run from here)
REPO = pathlib.Path(__file__).resolve().parents[1]
#: 60 samples typed at HLA-A, 266 SNPs within ±500 kb of the gene, 14
#: alleles in the population
PANEL = dict(n_samples=60, n_snps=266, n_alleles=14, locus="A", seed=11)
#: classifiers in the fixture model trained from the panel
MODEL_CLASSIFIERS = 16


def fixture_panel():
    """(HLATypeTable, SNPGenoData) of the fixture panel."""
    from hibag_tpu.data.panel import synthetic_locus
    p = PANEL
    return synthetic_locus(p["locus"], p["n_snps"], p["n_alleles"],
                           p["seed"]).draw(p["n_samples"], p["seed"] + 1)


def fixture_model(hla, geno):
    """The small model every prediction test imputes with."""
    from hibag_tpu.models.train import train_parallel
    return train_parallel(hla, geno, n_classifiers=MODEL_CLASSIFIERS,
                          batch=8, mode="host", seed=100, verbose=False)
