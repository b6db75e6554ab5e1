"""Process-level runtime settings: the compile cache's place and the one
GPU each distributed process opens."""

import os
import subprocess
import sys

import pytest

from _panel import REPO


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at one fixed path in the checkout, whatever the working directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c", "import hibag_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True)
    want = tmp_path / "cc" if env_dir else REPO / ".jax_cache"
    assert out.stdout.strip() == str(want)


@pytest.mark.parametrize("env,nproc,pid,want", [
    # one card per process from the launcher's local rank (the second
    # process of a host on a two-host job has global id 5)
    ({"LOCAL_RANK": "1"}, 8, 5, [1]),
    # the launcher gave each rank one visible card: JAX numbers it 0, so
    # nothing may be asked by rank
    ({"LOCAL_RANK": "3", "CUDA_VISIBLE_DEVICES": "3"}, 4, 3, None),
    ({"LOCAL_RANK": "2", "JAX_LOCAL_DEVICE_IDS": "2"}, 4, 2, None),
    # no local rank: JAX's own cluster detection decides
    ({}, 2, 1, None),
    # process id left to the cluster's detection
    ({"LOCAL_RANK": "0"}, 2, None, [0]),
])
def test_distributed_init_one_gpu_per_process(monkeypatch, env, nproc,
                                              pid, want):
    from hibag_tpu.parallel import mesh
    seen = {}
    for k in ("LOCAL_RANK", "CUDA_VISIBLE_DEVICES", "JAX_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    mesh.distributed_init("localhost:1234", nproc, pid)
    assert seen["local_device_ids"] == want
    assert seen["num_processes"] == nproc and seen["process_id"] == pid
