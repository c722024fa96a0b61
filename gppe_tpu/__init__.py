"""gppe_tpu — accelerator-native Gaussian-process hyperparameter estimation.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
package ``gaussian_proc`` (ameli/gaussian-process-param-estimation):
Matern covariance assembly, the mixed-correlation operator K + eta*I,
restricted/profile likelihood maximization, stochastic trace estimation
(Hutchinson / SLQ), and posterior sampling (HMC/NUTS) over kernel
hyperparameters — built around device meshes, collectives and fused GPU
kernels rather than as a translation of the reference's
Cython/OpenMP/imate stack.

Public API mirrors the reference's exports (reference:
gaussian_proc/__init__.py:72-75): ``GaussianProcess`` and
``generate_correlation``.
"""

from .ops.assembly import generate_correlation

__version__ = "0.1.0"

__all__ = ["GaussianProcess", "generate_correlation", "__version__"]


def __getattr__(name):
    # Lazy import keeps `import gppe_tpu` light (kernel-only uses don't pull
    # the inference stack).
    if name == "GaussianProcess":
        from .models.gaussian_process import GaussianProcess
        return GaussianProcess
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
