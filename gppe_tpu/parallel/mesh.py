"""Device meshes and multi-host initialization.

Replacement for the reference's process/MPI concurrency layer
(reference: multiprocessing pools at examples/FindOptimalCovarianceParameters.py:676-690,
Intel-MPI submission at jobfile.pbs:34-63). The two parallel axes of this
domain:

* ``probe`` — embarrassingly parallel batch axis: Hutchinson/SLQ probe
  vectors, HMC chains, (rho, nu) grid points. The analog of data
  parallelism; no communication except final psum-means.
* ``block`` — row-block sharding of the operator/vectors over n. The
  analog of tensor parallelism: matvecs need an all-gather of the
  (sharded) vector and reductions psum along this axis (NVLink between
  the cards of one host).
"""

import numpy as np

import jax

PROBE_AXIS = "probe"
BLOCK_AXIS = "block"


def make_mesh(n_devices=None, probe=None, devices=None):
    """Create a 2-D ('probe', 'block') mesh over the available devices.

    ``probe`` fixes the probe-axis extent; by default devices are split
    as evenly as possible with the block axis at least as large.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    nd = len(devices)
    if probe is None:
        # largest probe extent <= sqrt(nd) that divides nd
        probe = 1
        for cand in range(int(np.sqrt(nd)), 0, -1):
            if nd % cand == 0:
                probe = cand
                break
    if nd % probe != 0:
        raise ValueError(f"probe={probe} does not divide {nd} devices")
    block = nd // probe
    dev_array = np.asarray(devices).reshape(probe, block)
    return jax.sharding.Mesh(dev_array, (PROBE_AXIS, BLOCK_AXIS))


def multihost_init(coordinator_address=None, num_processes=None,
                   process_id=None):
    """Initialize the JAX distributed runtime (multi-host meshes).

    The replacement for the reference's mpirun/PBS layer
    (jobfile.pbs:34-63); call once per host before any jax op, with an
    explicit ``coordinator_address`` ('host:port'), process count and
    process id. No-op when running single-process.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def replicated(mesh):
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())


def row_sharded(mesh):
    """Shard the leading (n) axis over the block axis."""
    return jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(BLOCK_AXIS))


def probe_sharded(mesh, axis=1):
    """Shard the probe axis of an (n, p) array over the probe axis."""
    spec = [None, None]
    spec[axis] = PROBE_AXIS
    return jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(*spec))
