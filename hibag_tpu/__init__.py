"""hibag_tpu — HLA genotype imputation via attribute bagging, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the HIBAG
R package (reference: zhengxwen/HIBAG): ensemble classifiers trained by
bootstrap + greedy SNP selection + EM haplotype-frequency estimation, and
prediction by averaged posterior probabilities over unordered HLA genotype
pairs — reformulated as matmul chains instead of SIMD popcount loops.

HIBAG-style function aliases (hlaAttrBagging → train, hlaPredict → predict,
…) are exported for users migrating from the R package; see README.md for
the full mapping.
"""

import os

__version__ = "0.1.0"


#: the persistent compile cache's directory when JAX_COMPILATION_CACHE_DIR
#: is not set: one fixed path at the root of the checkout (a path that
#: moves never hits, since the path is part of the cache key)
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def _enable_compile_cache():
    """Persist compiled executables across processes (XLA compilation
    cache): a fused trainer's cold compile costs minutes, the serialized
    executable loads in seconds. JAX itself reads JAX_COMPILATION_CACHE_DIR
    when that is set; otherwise the cache goes to COMPILE_CACHE_DIR."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .constants import MAXNUM_SNP, MIN_RARE_FREQ
from .data.allele import (HLATypeTable, allele_digit, flanking_snps,
                          loci_info, sort_alleles, split_alleles,
                          unique_alleles)
from .data.geno import (SNPGenoData, align_to_model, combine_geno,
                        switch_strand)
from .data.misc import (check_allele, check_snps, sample_alleles,
                        summary_geno, summary_model, summary_table)
from .eval.assoc import aa_assoc_test, assoc_test, format_assoc
from .eval.compare import compare_alleles
from .eval.plots import (plot_call_rate, plot_call_threshold,
                         plot_ld_heatmap, plot_matching, plot_model)
from .eval.report import report
from .io.bed import read_bed, write_ped
from .io.rdata import read_rdata, read_rds, r_to_py
from .io.vcf import write_vcf
from .io.gds import read_gds
from .io.vcf_in import read_vcf
from .models.introspect import allele_distance, geno_ld, ld_matrix, summarize
from .models.model import AttrBagModel, Classifier, PackedEnsemble
from .models.predict import PredictionResult, predict
from .models.publish import (model_files, model_to_robj, out_of_bag,
                             pred_merge, publish, save_rdata)
from .models.train import (train, train_distributed, train_dynamic,
                           train_parallel)
from .seq.aa import (AASeqTable, conv_sequence, convert_table,
                     format_residue_table)
from .utils.rng import RRng

# ---------------------------------------------------------------------------
# R-API compatibility aliases (hla* names from the reference's NAMESPACE)
# ---------------------------------------------------------------------------

hlaAttrBagging = train
hlaParallelAttrBagging = train_parallel
hlaPredict = predict
hlaPredMerge = pred_merge
hlaCompareAllele = compare_alleles
def hlaAssocTest(obj, y, **kwargs):
    """Dispatch on input type like the reference's S3 generic: allele
    tables run per-allele tests; amino-acid tables run per-position tests."""
    if isinstance(obj, AASeqTable):
        return aa_assoc_test(obj, y, **kwargs)
    return assoc_test(obj, y, **kwargs)
hlaAllele = HLATypeTable.from_alleles
hlaAlleleDigit = allele_digit
hlaUniqueAllele = unique_alleles
hlaSplitAllele = split_alleles
hlaFlankingSNP = flanking_snps
hlaLociInfo = loci_info
hlaBED2Geno = read_bed
hlaGeno2PED = write_ped
hlaAlleleToVCF = write_vcf
hlaVCF2Geno = read_vcf
hlaGenoCombine = combine_geno
hlaGenoSwitchStrand = switch_strand
hlaPublish = publish
hlaModelFiles = model_files
hlaOutOfBag = out_of_bag
hlaDistance = allele_distance
hlaGenoLD = geno_ld
hlaLDMatrix = ld_matrix
hlaConvSequence = convert_table
hlaReport = report


def hlaReportPlot(pred=None, truth=None, model=None, fig="matching",
                  **kwargs):
    """Dispatch to the matplotlib diagnostic plots (hlaReportPlot,
    R/DataUtilities.R:2429)."""
    if fig == "matching":
        return plot_matching(pred=pred, model=model, **kwargs)
    if fig == "call.rate":
        return plot_call_rate(pred, truth, **kwargs)
    if fig == "call.threshold":
        return plot_call_threshold(pred, truth, **kwargs)
    raise ValueError(f"unknown fig {fig!r}")
hlaCheckAllele = check_allele
hlaCheckSNPs = check_snps
hlaSampleAllele = sample_alleles


def hlaCombineAllele(h1: HLATypeTable, h2: HLATypeTable) -> HLATypeTable:
    """Concatenate two HLA type tables with disjoint sample sets
    (reference R/DataUtilities.R:1287-1316)."""
    return h1.combine(h2)


def hlaSetKernelTarget(cpu: str = "max"):
    """Compatibility shim for the reference's SIMD-target selector
    (R/HIBAG.R hlaSetKernelTarget, src/HIBAG.cpp kernel dispatch).

    On an accelerator the compiler owns instruction selection, so there is
    nothing to switch; returns the active JAX backend/device description the way the
    reference returns the chosen CPU flags."""
    import jax
    dev = jax.devices()[0]
    return {"target": cpu, "backend": jax.default_backend(),
            "device": str(dev.device_kind
                          if hasattr(dev, "device_kind") else dev)}


hlaGDS2Geno = read_gds


def hlaMakeSNPGeno(genotype, sample_id, snp_id, snp_position, A_allele,
                   B_allele, assembly="auto"):
    """hlaMakeSNPGeno equivalent (R/DataUtilities.R:252)."""
    import numpy as _np
    allele = _np.array([f"{a}/{b}" for a, b in zip(A_allele, B_allele)],
                       dtype=object)
    return SNPGenoData(genotype=genotype, sample_id=sample_id, snp_id=snp_id,
                       snp_position=snp_position, snp_allele=allele,
                       assembly=assembly)


def hlaSNPID(obj, match_type="Position"):
    return obj.snp_key(match_type)


def hlaGenoAFreq(g):
    return g.allele_freq()


def hlaGenoMFreq(g):
    return g.maf()


def hlaGenoMRate(g):
    return g.missing_rate_snp()


def hlaGenoMRate_Samp(g):
    return g.missing_rate_samp()


def hlaGenoSubset(g, snp_sel=None, samp_sel=None):
    return g.subset(snp_mask=snp_sel, samp_mask=samp_sel)


def hlaGenoSubsetFlank(g, locus="any", flank_bp=500_000, assembly="hg19",
                       pos_mid=None):
    """Subset genotypes to the flanking region of a locus
    (hlaGenoSubsetFlank, R/DataUtilities.R:360)."""
    import numpy as _np
    ids = flanking_snps(g.snp_id, g.snp_position, locus, flank_bp,
                        assembly, pos_mid)
    return g.subset(snp_mask=_np.isin(g.snp_id.astype(str), ids.astype(str)))


def hlaAlleleSubset(t, samp_sel):
    return t.subset(samp_sel)


def hlaClose(model):
    """No-op: models are plain data, not native handles (reference
    hlaClose frees a C++ model slot, R/HIBAG.R:458)."""
    return None


def hlaModelToObj(model: AttrBagModel) -> dict:
    """Serialize to the reference's hlaAttrBagObj schema (plain dict)."""
    return model.to_hibag_obj()


def hlaModelFromObj(obj: dict, locus=None) -> AttrBagModel:
    """Rebuild a model from an hlaAttrBagObj-schema dict (or one decoded
    from an R .RData file via read_rdata + r_to_py)."""
    return AttrBagModel.from_hibag_obj(obj, locus=locus)


def hlaCombineModelObj(a: AttrBagModel, b: AttrBagModel) -> AttrBagModel:
    return a.combine(b)


def hlaSubModelObj(model: AttrBagModel, n: int) -> AttrBagModel:
    return model.subset_classifiers(n)
