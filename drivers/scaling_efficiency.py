"""Multi-device scaling harness (BASELINE: >= 0.8 efficiency to 4 hosts).

Measures the sharded profile-likelihood step (gppe_tpu.parallel.sharded)
at 1, 2, 4, ... devices on the same problem size (strong scaling) and
reports parallel efficiency. On a CPU session it uses the virtual device
mesh (xla_force_host_platform_device_count); on a pod slice it uses the
real devices — the code path is identical.
"""

import os as _os
import sys as _sys

# allow running as `python drivers/<name>.py` from anywhere
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def measure(n_devices, n, lanczos_steps=24, reps=3, probes_per_dev=8,
            comm="ring"):
    import jax
    import jax.numpy as jnp

    from gppe_tpu.parallel import mesh as mesh_mod
    from gppe_tpu.parallel import sharded
    from gppe_tpu.utils import data as data_utils

    mesh = mesh_mod.make_mesh(n_devices)
    probe_ext = int(mesh.shape[mesh_mod.PROBE_AXIS])

    rng = np.random.RandomState(0)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    probes = rng.choice([-1.0, 1.0],
                        size=(n, probes_per_dev * probe_ext))
    etas = jnp.asarray([0.1, 1.0, 10.0])

    step = sharded.build_sharded_profile_step(mesh, nu=0.5,
                                              lanczos_steps=lanczos_steps,
                                              comm=comm)
    args = (jnp.asarray(pts), jnp.asarray([0.1, 0.1]), jnp.asarray(X),
            jnp.asarray(z), jnp.asarray(probes), etas)
    out = step(*args)
    jax.block_until_ready(out)
    _ = float(out[0][0])  # force through the transfer path

    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(*args)
        _ = float(out[0][0])
    return (time.perf_counter() - t0) / reps


def main(n=4096, device_counts=None, verbose=True, comm="ring"):
    import jax

    nd_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= nd_avail]

    # Measurement grade (VERDICT r1/r2): a virtual CPU mesh
    # (xla_force_host_platform_device_count) validates that the sharded
    # program compiles, partitions, and stays correct as devices vary —
    # but its "efficiency" says NOTHING about interconnect bandwidth. Only
    # real multi-GPU hardware measures transfer-bound scaling.
    platform = jax.devices()[0].platform
    virtual = platform == "cpu"
    grade = ("correctness-grade (virtual CPU mesh — timings do not "
             "reflect an interconnect)" if virtual
             else f"perf-grade (real {platform} devices)")
    if verbose:
        print(f"measurement grade: {grade}")

    results = {"grade": "correctness" if virtual else "perf",
               "platform": platform}
    t1 = None
    for nd in device_counts:
        t = measure(nd, n, comm=comm)
        eff = (t1 / (t * nd)) if t1 is not None else 1.0
        if t1 is None:
            t1 = t
        results[nd] = {"seconds": t, "efficiency": eff}
        if verbose:
            print(f"{nd} devices: {t * 1e3:.1f} ms/step, "
                  f"efficiency {eff:.2f}"
                  + (" [correctness-grade]" if virtual else ""))
    return results


def measure_sampler(n_devices, num_chains=64, num_samples=100,
                    num_warmup=50, n_side=20, surface=None):
    """Chains-over-mesh HMC samples/s at ``n_devices`` (the chain axis
    shards over the mesh 'probe' axis). Returns (samples/s, surface) —
    pass the surface back in to reuse across device counts (the target
    is device-count independent; only the chain sharding changes)."""
    import jax

    from gppe_tpu.models import hmc
    from gppe_tpu.models.krylov_posterior import KrylovPosteriorSurface
    from gppe_tpu.parallel import mesh as mesh_mod
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(n_side, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    if surface is None:
        surface = KrylovPosteriorSurface(pts, z, X, nu=0.5,
                                         log10_rho_bounds=(-1.5, -0.5))
    mesh = mesh_mod.make_mesh(n_devices)
    kwargs = dict(nu=0.5, num_chains=num_chains,
                  num_samples=num_samples, num_warmup=num_warmup,
                  key=0, surface=surface, mesh=mesh,
                  log10_eta_bounds=(-3.0, 4.0))
    res, _ = hmc.sample_posterior_large(pts, z, X, **kwargs)
    jax.block_until_ready(res.samples)            # compile + warm
    t0 = time.perf_counter()
    res, _ = hmc.sample_posterior_large(pts, z, X, **kwargs)
    jax.block_until_ready(res.samples)
    wall = time.perf_counter() - t0
    return num_chains * num_samples / wall, surface


def main_artifact(n_step=8192, num_chains=64,
                  out_path="data/scaling_virtual_mesh.json",
                  verbose=True):
    """The VERDICT r4 item 9/6 artifact: (a) chains-over-mesh HMC
    samples/s at 1/2/4/8 devices; (b) ring vs allgather sharded-step
    wall time at the full mesh with n large enough that the gathered
    Krylov block dominates memory traffic. On a virtual CPU mesh both
    are CORRECTNESS-grade: they prove the programs partition and run at
    every device count, but say nothing about interconnect bandwidth (the
    'collectives' are memcpys inside one address space) — recorded in
    the artifact and discussed in docs/ARCHITECTURE.md."""
    import json

    import jax

    nd_avail = len(jax.devices())
    platform = jax.devices()[0].platform
    virtual = platform == "cpu"
    counts = [d for d in (1, 2, 4, 8) if d <= nd_avail]
    out = {"grade": "correctness" if virtual else "perf",
           "platform": platform,
           "note": ("virtual CPU mesh: numbers validate partitioning/"
                    "correctness only — no interconnect exists, so schedule "
                    "deltas measure scheduler+memcpy overhead, not "
                    "interconnect overlap" if virtual else
                    "real devices"),
           "sampler": {"num_chains": num_chains, "per_device": {}},
           "step_n": n_step, "step": {}}

    surface = None
    base = None
    for nd in counts:
        sps, surface = measure_sampler(nd, num_chains=num_chains,
                                       surface=surface)
        eff = sps / (base * nd) if base is not None else 1.0
        if base is None:
            base = sps
        out["sampler"]["per_device"][str(nd)] = {
            "samples_per_s": round(sps, 1),
            "efficiency_vs_1dev": round(eff, 3)}
        if verbose:
            print(f"sampler {nd} dev: {sps:.1f} samples/s "
                  f"({num_chains} chains)")

    for comm in ("ring", "allgather"):
        t = measure(max(counts), n_step, lanczos_steps=16, reps=3,
                    comm=comm)
        out["step"][comm] = round(t, 4)
        if verbose:
            print(f"step {comm} @ {max(counts)} dev, n={n_step}: "
                  f"{t:.3f}s")
    if out["step"].get("allgather"):
        out["step"]["ring_minus_allgather_s"] = round(
            out["step"]["ring"] - out["step"]["allgather"], 4)

    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    if verbose:
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--comm", choices=["ring", "allgather"],
                   default="ring",
                   help="matvec communication schedule")
    p.add_argument("--artifact", action="store_true",
                   help="produce data/scaling_virtual_mesh.json "
                        "(sampler scaling + ring-vs-allgather) on the "
                        "virtual 8-device CPU mesh")
    a = p.parse_args()
    if a.artifact:
        # measured on the virtual 8-device CPU mesh it claims, whatever
        # accelerator the machine has (the same override tests/conftest.py
        # applies)
        flags = _os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            _os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        main_artifact()
    else:
        main(a.n, comm=a.comm)
