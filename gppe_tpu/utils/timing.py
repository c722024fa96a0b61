"""Timing and profiling utilities.

Port of the reference's measurement tooling
(reference: examples/_utilities/processing_time_utilities.py:29-162 —
TimeCounter accumulator, single-processor pinning for honest CPU time,
process_time shim) extended with the accelerator equivalents: wall-clock
phase timers that block on device work, and jax.profiler trace capture.
"""

import contextlib
import os
import time

import jax


class TimeCounter:
    """Accumulates elapsed time across repeated calls — threaded through
    optimizers to isolate e.g. trace-estimation time
    (reference :29-115)."""

    def __init__(self):
        self.elapsed = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self):
        if self._t0 is None:
            raise RuntimeError("toc() without tic()")
        self.elapsed += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    def reset(self):
        self.__init__()


@contextlib.contextmanager
def phase_timer(name, results=None, block=True, verbose=False):
    """Wall-clock a phase, blocking on outstanding device work so the
    measurement is honest (the device analog of the reference's CPU-time
    bracketing, CompareVariousNumberOfPoints.py:67-78)."""
    if block:
        jax.effects_barrier()
    t0 = time.perf_counter()
    yield
    if block:
        jax.effects_barrier()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    if verbose:
        print(f"[{name}] {dt:.3f} s")


def restrict_computation_to_single_processor():
    """Pin host BLAS/OpenMP pools to one thread for fair CPU comparisons
    (reference :122-144). Device execution is unaffected."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = "1"


def process_time():
    """CPU process time (reference :151-162)."""
    return time.process_time()


@contextlib.contextmanager
def device_trace(log_dir="/tmp/gppe_trace"):
    """Capture a jax.profiler trace of the enclosed block (open with
    TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
