"""Benchmark workloads, built from the seeded panel generator
(hibag_tpu.data.panel), so bench.py and any profiling script time exactly
the same inputs without files from outside the repository.
"""

from __future__ import annotations

from ..data.panel import synthetic_locus

#: population seed shared by every workload below
SEED = 100


def headline(n_samples: int = 60, n_snps: int = 1000, n_alleles: int = 14):
    """Small-panel training shape: 60 samples x 1,000 SNPs within ±500 kb
    of HLA-A (the size of the HapMap CEU panel HIBAG ships with).
    Returns (population, hla_table, geno_data)."""
    pop = synthetic_locus("A", n_snps, n_alleles, seed=SEED)
    return (pop, *pop.draw(n_samples, SEED + 1))


def midscale(n_samples: int = 1000, n_snps: int = 266,
             n_alleles: int = 14):
    """Mid-scale training shape: 1,000 samples x 266 HLA-A-flanking SNPs
    (the shape BASELINE.md measured the reference kernel at).
    Returns (hla_table, geno_data)."""
    return synthetic_locus("A", n_snps, n_alleles, seed=SEED).draw(
        n_samples, SEED + 2)


def cohort(pop, n_samples: int):
    """(hla_table, geno_data) of ``n_samples`` fresh samples from ``pop``."""
    return pop.draw(n_samples, SEED + 3, id_prefix="c")
