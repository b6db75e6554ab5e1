"""Seeded synthetic HLA reference panels.

Every workload this repository builds — the tests' fixtures, the benchmark,
the on-device smoke run — comes from here, so no run needs files from
outside the repository. A panel is deterministic in its seed.

The population model is deliberately simple but keeps the properties that
drive HIBAG's cost and accuracy:

* one HLA locus whose allele frequencies are Zipf-skewed (a few common
  alleles, a long tail of rare ones);
* SNPs at hg19 positions within ±``FLANK_BP`` of the locus, grouped into LD
  blocks. Each block has a small bank of block haplotypes, and each HLA
  allele carries one block haplotype per block (its SNP template);
* lineages: alleles come in groups of ``ALLELES_PER_LINEAGE`` (the same
  first field of the name) that share one background template and depart
  from it in only ``ALLELE_BLOCKS`` blocks each, within ``ALLELE_BP`` of
  the gene, so alleles of a lineage are told apart by a few SNPs near the
  gene, as in real HLA lineages;
* recombination noise: on every chromosome, each block is replaced by a
  random block haplotype with a probability that grows with the block's
  distance from the locus, so SNPs near the gene tag the allele best;
* genotyping errors (a call replaced by another value) and missing calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GENO_MISSING
from .allele import HLATypeTable, loci_info
from .geno import SNPGenoData

#: SNP alleles: the four strand-unambiguous pairs (A/T and C/G would need
#: allele frequencies to resolve the strand, as on many genotyping arrays)
_BASES = np.array(["A/G", "C/T", "A/C", "G/T"], dtype=object)
ASSEMBLY = "hg19"
#: SNPs fall within this distance of the gene (HIBAG's default flank)
FLANK_BP = 500_000
#: exponent of the Zipf allele-frequency skew
ZIPF = 1.1
#: consecutive SNPs per LD block, and block haplotypes per block
BLOCK_SNPS = 16
N_PATTERNS = 8
#: per-chromosome swap probability of a block at the flank's edge (none
#: over the gene, linear in between)
MAX_RECOMB = 0.1
#: alleles per lineage, and the blocks where each departs from its
#: lineage's background (the lineage's first allele departs nowhere),
#: chosen among the blocks centred within ALLELE_BP of the gene
ALLELES_PER_LINEAGE = 4
ALLELE_BLOCKS = 2
ALLELE_BP = 150_000


@dataclass(frozen=True)
class SyntheticLocus:
    """A seeded population at one HLA locus; ``draw`` samples a panel."""

    locus: str
    alleles: np.ndarray        # object [A] allele names
    allele_freq: np.ndarray    # f64 [A], Zipf-skewed, sums to 1
    snp_id: np.ndarray         # object [P]
    snp_position: np.ndarray   # int64 [P], sorted
    snp_allele: np.ndarray     # object [P]
    block: np.ndarray          # int [P] LD-block index of each SNP
    patterns: np.ndarray       # uint8 [N_PATTERNS, P] bit per block haplotype
    template: np.ndarray       # int [A, n_blocks] block haplotype per allele
    recomb: np.ndarray         # f64 [n_blocks] per-chromosome swap probability
    error_rate: float
    missing_rate: float

    def draw(self, n_samples: int, seed: int, id_prefix: str = "s"):
        """(HLATypeTable, SNPGenoData) for ``n_samples`` fresh samples."""
        rng = np.random.default_rng(seed)
        A = len(self.alleles)
        npat, P = self.patterns.shape
        nb = self.template.shape[1]
        a = rng.choice(A, size=(2, n_samples), p=self.allele_freq)
        # block haplotype per chromosome: the allele's template, swapped for
        # a random one where recombination broke the LD
        pat = self.template[a].astype(np.uint8)               # [2, N, nb]
        swap = rng.random((2, n_samples, nb)) < self.recomb
        pat = np.where(swap, rng.integers(0, npat, pat.shape, np.uint8), pat)
        geno = np.empty((n_samples, P), np.uint8)
        cols = np.arange(P)
        for i in range(0, n_samples, 4096):      # bounds the index arrays
            pp = pat[:, i:i + 4096][:, :, self.block]          # [2, n, P]
            geno[i:i + 4096] = self.patterns[pp, cols].sum(0)
        err = rng.random(geno.shape) < self.error_rate
        geno = np.where(err, (geno + rng.integers(1, 3, geno.shape)) % 3,
                        geno).astype(np.uint8)
        geno[rng.random(geno.shape) < self.missing_rate] = GENO_MISSING
        sid = np.array([f"{id_prefix}{i}" for i in range(n_samples)],
                       dtype=object)
        hla = HLATypeTable.from_alleles(
            sid, self.alleles[a[0]], self.alleles[a[1]], locus=self.locus,
            assembly=ASSEMBLY)
        snp = SNPGenoData(genotype=geno.T.copy(), sample_id=sid,
                          snp_id=self.snp_id, snp_position=self.snp_position,
                          snp_allele=self.snp_allele, assembly=ASSEMBLY)
        return hla, snp


def synthetic_locus(locus: str = "A", n_snps: int = 1000,
                    n_alleles: int = 40, seed: int = 0,
                    error_rate: float = 0.01,
                    missing_rate: float = 0.01) -> SyntheticLocus:
    """Build the seeded population at ``locus`` (see the module docstring):
    ``n_snps`` SNPs within ±``FLANK_BP`` of the gene (one SNP per kb at the
    defaults' 1,000 SNPs over ±500 kb) and ``n_alleles`` alleles."""
    rng = np.random.default_rng(seed)
    _, start, end, _ = loci_info(ASSEMBLY)[locus]
    mid = (start + end) // 2
    lo, hi = start - FLANK_BP, end + FLANK_BP
    pos = np.sort(rng.choice(np.arange(lo, hi + 1), n_snps, replace=False))
    block = np.minimum(np.arange(n_snps) // BLOCK_SNPS,
                       max(n_snps // BLOCK_SNPS - 1, 0))
    nb = int(block.max()) + 1
    # block haplotypes: pattern k of block b carries bit patterns[k, p] at
    # each SNP p of the block, drawn at a per-SNP allele frequency
    maf = rng.uniform(0.05, 0.5, n_snps)
    patterns = (rng.random((N_PATTERNS, n_snps)) < maf).astype(np.uint8)
    centre = np.array([pos[block == b].mean() for b in range(nb)])
    near = np.argsort(np.abs(centre - mid))
    near = near[:max(np.sum(np.abs(centre - mid) <= ALLELE_BP),
                     min(ALLELE_BLOCKS, nb))]
    lineage = np.arange(n_alleles) // ALLELES_PER_LINEAGE
    template = rng.integers(0, N_PATTERNS, (int(lineage.max()) + 1, nb))
    template = template[lineage]
    for k in np.flatnonzero(np.arange(n_alleles) % ALLELES_PER_LINEAGE):
        b = rng.choice(near, min(ALLELE_BLOCKS, len(near)), replace=False)
        template[k, b] = ((template[k, b]
                           + rng.integers(1, N_PATTERNS, len(b)))
                          % N_PATTERNS)
    recomb = MAX_RECOMB * np.clip(np.abs(centre - mid) / FLANK_BP, 0, 1)
    freq = 1.0 / np.arange(1, n_alleles + 1) ** ZIPF
    names = np.array([f"{1 + k // ALLELES_PER_LINEAGE:02d}:"
                      f"{1 + k % ALLELES_PER_LINEAGE:02d}"
                      for k in range(n_alleles)], dtype=object)
    return SyntheticLocus(
        locus=locus, alleles=names, allele_freq=freq / freq.sum(),
        snp_id=np.array([f"rs{p}" for p in pos], dtype=object),
        snp_position=pos.astype(np.int64),
        snp_allele=_BASES[rng.integers(0, len(_BASES), n_snps)],
        block=block, patterns=patterns, template=template, recomb=recomb,
        error_rate=error_rate, missing_rate=missing_rate)
