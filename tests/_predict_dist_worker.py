"""Worker for the 2-process distributed-prediction test: each process
imputes its sample share of the seeded fixture panel with the fixture
model and all-gathers; both must hold the full, identical result.

Usage: python _predict_dist_worker.py <coordinator> <nproc> <pid> <out.npz>
"""

import sys

import numpy as np


def main():
    coordinator, nproc, pid, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import jax
    jax.config.update("jax_platforms", "cpu")

    from hibag_tpu.parallel.mesh import distributed_init, predict_distributed

    # the runtime starts before any JAX computation (training the model)
    distributed_init(coordinator, nproc, pid)
    from _panel import fixture_model, fixture_panel
    hla, geno = fixture_panel()
    model = fixture_model(hla, geno)

    res = predict_distributed(model, geno, with_prob=True)
    np.savez(out, sample_id=res.sample_id.astype(str),
             allele1=res.allele1.astype(str), allele2=res.allele2.astype(str),
             prob=res.prob, matching=res.matching, postprob=res.postprob)
    print(f"proc {pid}: {len(res.sample_id)} samples gathered")


if __name__ == "__main__":
    main()
