"""Multi-host (multi-process) sharded solve, simulated with two local
processes over the Gloo CPU backend.

This is the ">= 2 hosts" scaling check run without a cluster: each process owns half the scenario batch on its own 4 virtual
devices; the solve runs under one global 8-device mesh with psum'd stats.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_ENABLE_X64"] = "0"
    import jax
    rank = int(sys.argv[1])
    from ilqr_tpu.parallel.mesh import initialize_distributed
    initialize_distributed(coordinator_address="127.0.0.1:12411",
                           num_processes=2, process_id=rank)
    import jax.numpy as jnp
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.parallel import make_mesh, sharded_solve_fn
    from ilqr_tpu.parallel.sharding import replicate, shard_batch_multihost
    from ilqr_tpu.sim.scenario import build_scenario_setup, perturbed_initial_states
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(sys.argv[2])
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, max_iter=8)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scenario = st.device_scenario(tick=0, dtype=jnp.float32)

    B_global, n_local = 16, 8
    # every process computes the same global batch definition, then feeds
    # only its own rows
    x0_all = perturbed_initial_states(st.ego_x0, B_global, seed=7)
    my = x0_all[rank * n_local:(rank + 1) * n_local].astype("float32")
    scen_local = jax.tree.map(lambda a: jnp.stack([a] * n_local), scenario)

    mesh = make_mesh(8)
    fn = sharded_solve_fn(mesh, cfg)
    x0_g = shard_batch_multihost(mesh, jnp.asarray(my))
    scen_g = shard_batch_multihost(mesh, scen_local)
    u, x, stats, summary = fn(replicate(mesh, w), x0_g, scen_g)
    print("RESULT", rank, float(summary["num_solves"]),
          float(summary["total_iters"]), float(summary["converged_frac"]),
          flush=True)

    # the GPU engine over the same multi-host feeding path: the fused
    # kernel (in the Pallas interpreter on CPU) per shard with straggler
    # compaction, reduced shapes as tests/test_sharding.py
    import dataclasses
    from ilqr_tpu.parallel import sharded_kernel_solve_fn
    cfg_k = dataclasses.replace(cfg, N=6)
    scen_k = st.device_scenario(tick=0, horizon=cfg_k.N, dtype=jnp.float32)
    scen_k_local = jax.tree.map(lambda a: jnp.stack([a] * n_local), scen_k)
    fn_k = sharded_kernel_solve_fn(mesh, cfg_k, window=64, straggler_cap=3,
                                   interpret=True, block=2)
    u_k, x_k, stats_k, summary_k = fn_k(
        replicate(mesh, w), x0_g, shard_batch_multihost(mesh, scen_k_local))
    print("KRESULT", rank, float(summary_k["num_solves"]),
          float(summary_k["total_iters"]), float(summary_k["converged_frac"]),
          flush=True)
""")


@pytest.mark.skipif(os.environ.get("ILQR_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
def test_two_process_sharded_solve(tmp_path):
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "scenario_two_straight.yaml")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), cfg_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.path.join(os.path.dirname(__file__), ".."))
        for r in range(2)
    ]
    results, kresults = {}, {}
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, rank, n, iters, conv = line.split()
                results[int(rank)] = (float(n), float(iters), float(conv))
            elif line.startswith("KRESULT"):
                _, rank, n, iters, conv = line.split()
                kresults[int(rank)] = (float(n), float(iters), float(conv))
    assert set(results) == {0, 1}
    # psum'd summary identical on both hosts and covers the global batch
    assert results[0] == results[1]
    assert results[0][0] == 16.0
    # kernel engine over the same multihost feeding path
    assert set(kresults) == {0, 1}
    assert kresults[0] == kresults[1]
    assert kresults[0][0] == 16.0
    assert kresults[0][1] > 0  # solver actually iterated
