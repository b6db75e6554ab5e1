"""Worker process for the 2-process distributed-training test.

Usage: python _dist_worker.py <coordinator> <num_procs> <proc_id> <out.npz>

Each process trains its deterministic share of a 4-classifier ensemble on
the seeded fixture panel, all-gathers the classifiers, and writes the
merged model's snp_index arrays — every process must end up with the same
full ensemble (the reference's master-side combine, R/HIBAG.R:293-451,
done as a collective instead).
"""

import os
import sys

import numpy as np


def main():
    coordinator, num_procs, proc_id, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "host"
    import jax
    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS")
                      or "cpu")

    from _panel import fixture_panel
    from hibag_tpu.models.train import train_distributed

    t, fg = fixture_panel()

    m = train_distributed(t, fg, n_classifiers=4, seed=100, batch=2,
                          verbose=False, coordinator=coordinator,
                          num_processes=num_procs, process_id=proc_id,
                          mode=mode)
    np.savez(out, n=m.n_classifiers, local=len(jax.local_devices()),
             **{"global": jax.device_count()},
             **{f"snp{k}": c.snp_index for k, c in enumerate(m.classifiers)},
             **{f"oob{k}": c.oob_accuracy
                for k, c in enumerate(m.classifiers)})
    print(f"proc {proc_id}: gathered {m.n_classifiers} classifiers")


if __name__ == "__main__":
    main()
