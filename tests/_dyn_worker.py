"""Worker for test_train_dynamic_two_processes_straggler.

Usage: python tests/_dyn_worker.py <coordinator> <nproc> <pid> <work_dir>
       <out.npz> [sleep_s]

Process `pid` optionally sleeps before claiming (a straggler): the other
process should pick up most jobs, and the merged model must still equal
the single-process result (per-classifier RNG substreams are id-derived).
"""

import sys
import time

import numpy as np


def main():
    coord, nproc, pid, work_dir, out = sys.argv[1:6]
    sleep_s = float(sys.argv[6]) if len(sys.argv) > 6 else 0.0
    import jax
    jax.config.update("jax_platforms", "cpu")

    from _panel import fixture_panel
    from hibag_tpu.models.train import train_dynamic
    from hibag_tpu.parallel.mesh import distributed_init

    distributed_init(coord, int(nproc), int(pid))
    if sleep_s:
        time.sleep(sleep_s)

    t, fg = fixture_panel()
    m = train_dynamic(t, fg, n_classifiers=4, seed=100, job_size=1,
                      work_dir=work_dir, verbose=False, mode="host")
    np.savez(out, n=m.n_classifiers,
             **{f"snp{k}": c.snp_index
                for k, c in enumerate(m.classifiers)})


if __name__ == "__main__":
    main()
