"""Multi-chip ensemble parallelism over a jax.sharding.Mesh.

The reference scales out by training whole classifiers in independent R
worker processes and concatenating them (hlaParallelAttrBagging +
.DynamicClusterCall, reference R/HIBAG.R:293-451, R/DataUtilities.R:124-213),
and by splitting samples across workers for prediction (R/HIBAG.R:764-807).

Device equivalent: a 1-D device mesh with axis "ens". Training shards a
*batch of classifiers* (each with its own bootstrap and haplotype state)
across devices — training data is replicated, so the greedy-step kernels run
embarrassingly parallel and XLA inserts no cross-device traffic. Prediction
shards classifiers and reduces the weighted ensemble posterior with a
cross-device sum (an all-reduce), replacing the reference's
master-side prob merging (HIBAG_SumList / UpdateAddProbW / NormalizeProb,
src/HIBAG.cpp:1463-1547).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import GENO_MISSING
from ..models.em import em_all_candidates, erase_rare, evaluate_candidates
from ..ops.scoring import posterior_scores, unordered_from_S


def ensemble_mesh(devices=None, name: str = "ens") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (name,))


def shard_ensemble(mesh: Mesh, tree, name: str = "ens"):
    """Put classifier-major arrays (axis 0 = classifier) on the mesh."""
    sh = NamedSharding(mesh, P(name))
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sh), tree)


def replicate(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sh), tree)


# ---------------------------------------------------------------------------
# multi-host orchestration
# ---------------------------------------------------------------------------

def _local_device_ids() -> Optional[list]:
    """The one card of this process from its launcher's ``LOCAL_RANK``
    (its rank among the processes of its host), or None to leave the
    choice to JAX: when the launcher already restricted the process with
    ``CUDA_VISIBLE_DEVICES`` or ``JAX_LOCAL_DEVICE_IDS``, or gives no local
    rank (JAX then takes a managed cluster's local rank, SLURM's or Open
    MPI's, or else opens every card of the host)."""
    env = os.environ
    if ("CUDA_VISIBLE_DEVICES" in env or "JAX_LOCAL_DEVICE_IDS" in env
            or "LOCAL_RANK" not in env):
        return None
    return [int(env["LOCAL_RANK"])]


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> tuple:
    """Initialize the JAX multi-host runtime (no-op when single-process).

    The reference scales across machines with R PSOCK clusters and a
    hand-rolled job farm (.DynamicClusterCall, R/DataUtilities.R:124-213);
    here the JAX distributed runtime provides process identity and the
    global device mesh. Each process opens the cards its launcher gives it
    (see ``_local_device_ids``), so several processes on one host each
    open their own card instead of all opening every card. Returns
    (process_index, process_count).
    """
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=_local_device_ids())
    return jax.process_index(), jax.process_count()


def classifier_range(n_classifiers: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> range:
    """This host's contiguous share of the ensemble (deterministic split —
    every host derives the same partition, so per-classifier RNG seeds
    stay stable regardless of topology)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = (n_classifiers + pc - 1) // pc
    lo = pi * per
    return range(lo, min(lo + per, n_classifiers))


def allgather_pickled(obj) -> list:
    """All-gather an arbitrary picklable object across processes with a
    two-phase variable-size exchange (lengths first, then a max-padded
    buffer — no fixed size ceiling). Returns the per-process objects."""
    from jax.experimental import multihost_utils
    import pickle
    blob = pickle.dumps(obj)
    size = np.array([len(blob)], dtype=np.int64)
    sizes = multihost_utils.process_allgather(size)
    pad = int(sizes.max())
    buf = np.zeros(pad, dtype=np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    bufs = multihost_utils.process_allgather(buf)
    return [pickle.loads(bytes(bufs[i][:int(sizes[i][0])]))
            for i in range(jax.process_count())]


def gather_classifiers(local_model, n_classifiers: int):
    """All-gather serialized classifiers across hosts (single-process:
    identity) — the replacement for the reference's master-side
    combine (hlaCombineModelObj)."""
    if jax.process_count() == 1:
        return local_model
    chunks = allgather_pickled(local_model.to_hibag_obj()["classifiers"])
    all_classifiers = []
    for chunk in chunks:
        all_classifiers.extend(chunk)
    obj = local_model.to_hibag_obj()
    obj["classifiers"] = all_classifiers[:n_classifiers]
    from ..models.model import AttrBagModel
    merged = AttrBagModel.from_hibag_obj(obj, locus=local_model.locus)
    merged.sample_id = local_model.sample_id
    return merged


def sample_range(n_samples: int, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> range:
    """This host's contiguous sample share for distributed prediction."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = (n_samples + pc - 1) // pc
    lo = pi * per
    return range(lo, min(lo + per, n_samples))


def predict_distributed(model, data, coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None, **kwargs):
    """Multi-host prediction: each process imputes its contiguous sample
    share on its local devices, results all-gather, and every process
    returns the FULL cohort's PredictionResult — the reference's
    hlaPredict(cl=) worker split + master merge (R/HIBAG.R:764-807) as a
    collective. Single-process: equivalent to predict().

    kwargs pass through to predict() (vote, engine, mesh, type, ...).
    """
    from ..models.predict import PredictionResult, predict
    pi, pc = distributed_init(coordinator, num_processes, process_id)
    if pc == 1:
        return predict(model, data, **kwargs)
    rng = sample_range(data.n_samp, pi, pc)
    local = predict(model, data.subset(samp_mask=np.asarray(rng)), **kwargs)
    parts = allgather_pickled({
        "sample_id": local.sample_id, "allele1": local.allele1,
        "allele2": local.allele2, "prob": local.prob,
        "matching": local.matching, "dosage": local.dosage,
        "postprob": local.postprob})

    def cat(key, axis=0):
        vals = [p[key] for p in parts]
        if any(v is None for v in vals):
            return None
        return np.concatenate(vals, axis=axis)

    return PredictionResult(
        sample_id=cat("sample_id"), allele1=cat("allele1"),
        allele2=cat("allele2"), prob=cat("prob"), matching=cat("matching"),
        dosage=cat("dosage", axis=1), postprob=cat("postprob", axis=1),
        hla_alleles=local.hla_alleles, locus=local.locus,
        match_info=local.match_info)


# ---------------------------------------------------------------------------
# batched (multi-classifier) greedy training step
# ---------------------------------------------------------------------------

def _grow_step_single(bits, freq, allele, geno_sel, B, is_oob, g_cand,
                      afreq, new_col, a1, a2, n_alleles, rare_prob, total_n):
    """Device work of ONE greedy step for ONE classifier (no decisions)."""
    valid = freq > 0
    fA, fB, ll_em, _ = em_all_candidates(freq, valid, bits, allele,
                                         geno_sel, a1, a2, B, g_cand,
                                         afreq, total_n)
    fA, fB = erase_rare(fA, fB, rare_prob)
    acc, loss = evaluate_candidates(bits, allele, new_col, fA, fB, g_cand,
                                    geno_sel, a1, a2, is_oob, B, n_alleles)
    return fA, fB, acc, loss


@functools.partial(jax.jit, static_argnames=("n_alleles",))
def batched_grow_step(bits, freq, allele, geno_sel, B, is_oob, g_cand, afreq,
                      new_col, a1, a2, rare_prob, total_n, n_alleles):
    """One greedy step for a BATCH of classifiers (leading axis K).

    bits [K,H,L]; freq [K,H]; allele [K,H]; geno_sel [K,N,L]; B [K,N];
    g_cand [K,C,N]; afreq [K,C]; new_col [K] int32; a1/a2 [N] replicated.

    With the K axis sharded over the mesh, XLA partitions the whole step
    across devices with zero communication — the analogue of the
    reference's per-process classifier training.
    """
    fn = jax.vmap(_grow_step_single,
                  in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0,
                           None, None, None, None, None))
    return fn(bits, freq, allele, geno_sel, B, is_oob, g_cand, afreq,
              new_col, a1, a2, n_alleles, rare_prob, total_n)


# ---------------------------------------------------------------------------
# sharded ensemble prediction
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_alleles",))
def sharded_predict(hap_bits, hap_freq, hap_allele, snp_index, snp_weight,
                    geno_codes, n_alleles):
    """Ensemble posterior with classifiers sharded across devices.

    hap_bits [C,Hm,L] (sharded on C), hap_freq [C,Hm], hap_allele [C,Hm],
    snp_index [C,L]; snp_weight [P], geno_codes [N,P] (replicated).

    Returns (ens [N,A,A] weight-normalized, wsum [N]) — the classifier sum
    crosses the mesh axis, so XLA lowers it to an all-reduce.
    """
    A = n_alleles

    def one_classifier(bits, freq, allele, sidx):
        safe = jnp.maximum(sidx, 0)
        in_cls = sidx >= 0
        g = jnp.take(geno_codes, safe, axis=1)
        g = jnp.where(in_cls[None, :], g, GENO_MISSING).astype(jnp.int8)
        wsnp = jnp.take(snp_weight, safe) * in_cls
        nonmiss = g != GENO_MISSING
        w = ((nonmiss * wsnp[None, :]).sum(-1)
             / jnp.maximum(wsnp.sum(), 1)).astype(jnp.float32)
        res = posterior_scores(bits, freq, allele, g, A)
        Q = unordered_from_S(res["S"])
        contrib = Q * (w / jnp.maximum(res["total"], 1e-30))[:, None, None]
        return contrib, w

    contribs, ws = jax.vmap(one_classifier)(hap_bits, hap_freq, hap_allele,
                                            snp_index)
    ens = contribs.sum(0)           # cross-device reduction on the mesh
    wsum = ws.sum(0)
    return ens / jnp.maximum(wsum, 1e-30)[:, None, None], wsum
