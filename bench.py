"""Timing driver: prints ONE JSON line with the device and its timings.

Workloads come from the seeded panel generator (hibag_tpu.utils.bench_data):

* training: classifiers/s of a 25-classifier fused-mode ensemble on a
  60-sample x 1,000-SNP panel at HLA-A (warm, best of 3);
* prediction: samples/s of that ensemble on 3,840 and 51,200 fresh samples
  (warm, best of 3);
* mid-scale training: classifiers/s of 8 classifiers on 1,000 samples x
  266 SNPs (warm, best of 3).

Refuses to run, with no fallback, where JAX finds no GPU. Benchmark cells
and their metrics are defined in BENCHMARK.json once it exists; this
script only times the main entry points.
"""

import json
import sys
import time

import numpy as np


def _stage(msg: str) -> None:
    """Progress to stderr (stdout carries only the final JSON line)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()


def _best(fn, reps=3):
    fn()                                     # warmup: compiles every shape
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs an NVIDIA GPU, JAX found "
                 f"{jax.default_backend()!r}")
    from hibag_tpu.models.predict import predict
    from hibag_tpu.models.train import train_parallel
    from hibag_tpu.utils.bench_data import cohort, headline, midscale

    pop, hla, geno = headline()
    n_cls = 25
    kw = dict(n_classifiers=n_cls, batch=n_cls, verbose=False,
              with_matching=False, mode="fused", hcap=128, max_steps=192,
              on_overflow="freeze", seed=100)
    _stage("training")
    train_s, model = _best(lambda: train_parallel(hla, geno, **kw))
    _stage(f"training: {n_cls / train_s:.2f} cls/s")

    rates = {}
    for n in (3840, 51_200):
        chla, cg = cohort(pop, n)
        _stage(f"predict {n}")
        pred_s, res = _best(lambda: predict(model, cg))
        rates[n] = n / pred_s
        acc = res.accuracy_vs(chla.allele1, chla.allele2)
        _stage(f"predict {n}: {rates[n]:.0f} samples/s, accuracy {acc:.4f}")

    hla_m, geno_m = midscale()
    mkw = dict(kw, n_classifiers=8, batch=8, hcap=256)
    _stage("mid-scale training")
    mid_s, _ = _best(lambda: train_parallel(hla_m, geno_m, **mkw))

    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "train_classifiers_per_s": n_cls / train_s,
        "mean_oob_accuracy": float(np.mean(
            [c.oob_accuracy for c in model.classifiers])),
        "predict_samples_per_s": rates[3840],
        "cohort_predict_samples_per_s": rates[51_200],
        "midscale_train_cls_per_s_1000x266": 8 / mid_s,
        "n_snp": int(geno.n_snp),
        "n_samp": int(geno.n_samp),
    }))


if __name__ == "__main__":
    sys.exit(main() or 0)
