"""GPU test tier: the production path on a real card.

``tests/`` forces the virtual 8-device CPU mesh with x64 — the right
default for logic tests, but it cannot catch f32 precision drift on the
card, compiled (non-interpret) kernel behavior or what the GPU compiler
refuses. This tier runs a small suite on one GPU with the production
dtype policy (f32 device math, f64 inference scalars, compiled Pallas
kernels). It skips itself where JAX finds no GPU, and runs in one
process (never under xdist: one JAX process per card).

    python -m pytest tests_gpu -q -p no:xdist

chip_smoke.py runs it in its own process through pytest.main.
"""

import pytest


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        raise pytest.UsageError("tests_gpu runs in one process (one JAX "
                                "process per card): pass -p no:xdist")


def pytest_collection_modifyitems(config, items):
    for item in items:
        item.add_marker(pytest.mark.gpu)


@pytest.fixture(scope="session", autouse=True)
def gpu_session():
    import jax

    from gppe_tpu.utils import config as cfg
    if jax.devices()[0].platform != "gpu":
        pytest.skip("tests_gpu needs a GPU (JAX found "
                    f"{jax.devices()[0].platform})")
    cfg.setup()
