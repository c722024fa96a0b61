"""Stochastic trace estimation: batched Lanczos / SLQ and Hutchinson.

Replacement for the reference's external imate backend
(reference: gaussian_proc/_mixed_correlation/mixed_correlation.py:17,44,
138-143,193-209,263-268 — imate.trace/traceinv/logdet with methods
'hutchinson'/'slq' and imate.AffineMatrixFunction). Design:

* Probe vectors are a *batch axis*: Lanczos runs vmapped over probes, so
  all probe tridiagonalizations execute as one batched XLA program whose
  matvecs are (n, p) matmuls rather than p sequential (n,) matvecs. On
  a mesh, the probe axis shards (see gppe_tpu.parallel).
* The affine-family amortization (imate.AffineMatrixFunction's trick):
  Lanczos tridiagonalizes K *once*; for any eta, f(K + eta I) uses the
  same Ritz pairs with shifted nodes theta + eta. Every trace quantity at
  every optimizer iterate reuses one Krylov factorization.
* Ritz values/weights are promoted to float64 on the host: the quadrature
  sums are tiny (p x k) and precision-critical, while the O(n k p) Lanczos
  matvecs stay in the accelerator compute dtype.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import compute_dtype, inference_dtype


def _as_matvec(K):
    if callable(K):
        return K
    if hasattr(K, "matmat"):
        return lambda V: K.matmat(V)
    return lambda V: jnp.matmul(K, V, precision="highest")


@partial(jax.jit, static_argnames=("matvec", "num_steps", "reorthogonalize",
                                   "precise_sums"))
def lanczos(matvec, V0, num_steps, reorthogonalize=True,
            precise_sums=None, operands=()):
    """Batched Lanczos tridiagonalization.

    ``V0``: (n, p) starting block (columns are independent runs).
    ``operands``: extra TRACED arrays forwarded to ``matvec(V,
    *operands)`` — operators whose matvec consumes large precomputed
    arrays (GridMaternOperator's FFT table) must receive them as
    program ARGUMENTS: closure-captured device arrays constant-fold
    into the jitted program (a large complex FFT table embedded in every
    compiled program). Engines read them from the operator's
    ``jit_operands`` attribute.
    Returns (alphas (p, k), betas (p, k-1), V (k, p, n)) with V the
    orthonormal Lanczos bases (needed for solve-reuse; slice [:0] if not).
    V's layout puts n last, so each basis vector is contiguous.

    Full reorthogonalization (Gram-Schmidt against all previous vectors,
    batched as (k, n, p) tensor contractions) is on by default — in f32,
    loss of orthogonality otherwise corrupts the Ritz spectrum.

    ``precise_sums`` (default: on when jax x64 is enabled): accumulate the
    tridiagonal coefficients alpha = q.w and beta = |w| in float64. The
    O(n) f32 reductions carry ~sqrt(n)*eps relative noise (~1e-4 at
    n = 10^5) which enters T *systematically*; the Gauss-quadrature
    traces inherit it as a BIAS that no probe count removes — measured
    der1 bias 0.5 at n = 16384 f32 vs < 1e-3 with f64 sums (the exact
    spectral oracle). The vectors and the matvec stay in f32; the f64
    work is two O(n p) reductions per step — invisible next to the
    O(n^2 p) matvec.
    """
    n, p = V0.shape
    dtype = V0.dtype
    k = num_steps
    if precise_sums is None:
        precise_sums = jax.config.jax_enable_x64
    elif precise_sums and not jax.config.jax_enable_x64:
        # with x64 off, jnp.float64 silently maps to float32 and the
        # promised f64 accumulation quietly doesn't happen
        import warnings
        warnings.warn(
            "lanczos(precise_sums=True) requires jax_enable_x64; x64 is "
            "off, so sums fall back to the compute dtype (call "
            "gppe_tpu.utils.config.setup() or ensure_inference_precision "
            "first)", stacklevel=2)
    sum_dt = jnp.float64 if precise_sums else dtype

    def _dot_rows(a, b):
        """Per-row a.b (over n) in the accumulation dtype."""
        return jnp.sum((a * b).astype(sum_dt), axis=1)

    # The whole iteration runs in (p, n) orientation — n minor; only the
    # matvec boundary transposes, once per step.
    q = jnp.transpose(V0)                               # (p, n)
    nrm0 = jnp.sqrt(_dot_rows(q, q))
    q = q / nrm0.astype(dtype)[:, None]
    V = jnp.zeros((k, p, n), dtype=dtype)
    V = V.at[0].set(q)
    alphas = jnp.zeros((p, k), dtype=sum_dt)
    betas = jnp.zeros((p, k - 1), dtype=sum_dt)

    def body(j, carry):
        V, alphas, betas, q, q_prev, beta_prev = carry
        # pin the vector dtype: an operator that promotes (e.g. a f64
        # dense matrix under x64) must not flip the f32 iteration
        w = jnp.transpose(
            matvec(jnp.transpose(q), *operands).astype(dtype))  # (p, n)
        alpha = _dot_rows(q, w)                         # (p,) f64
        w = (w - alpha.astype(dtype)[:, None] * q
             - beta_prev[:, None] * q_prev)
        if reorthogonalize:
            # w -= V_i (V_i . w) for all i <= j (masked): einsum over k
            mask = (jnp.arange(k) <= j).astype(dtype)   # (k,)
            coeffs = jnp.einsum("ipn,pn->ip", V, w,
                                precision="highest") * mask[:, None]
            w = w - jnp.einsum("ipn,ip->pn", V, coeffs, precision="highest")
        beta = jnp.sqrt(_dot_rows(w, w))
        beta_safe = jnp.where(beta > 0, beta, 1.0).astype(dtype)
        q_next = w / beta_safe[:, None]
        V = V.at[j + 1].set(jnp.where(j + 1 < k, q_next, V[j + 1]))
        alphas = alphas.at[:, j].set(alpha)
        betas = jax.lax.cond(
            j < k - 1, lambda b: b.at[:, j].set(beta), lambda b: b, betas)
        return (V, alphas, betas, q_next, q, beta.astype(dtype))

    init = (V, alphas, betas, q, jnp.zeros_like(q),
            jnp.zeros(p, dtype=dtype))
    V, alphas, betas, q, q_prev, beta_prev = jax.lax.fori_loop(
        0, k, body, init)
    return alphas, betas, V


def gram_f64(Vm, block=8192):
    """Vm @ Vm.T with float64 accumulation from f32 block products.

    The Krylov engines' per-eta math consumes Gram matrices of O(n)
    vectors; a straight f32 matmul's accumulated rounding (~sqrt(n)*eps)
    enters the profile derivative as a systematic error (same mechanism
    as the Lanczos-coefficient bias, see :func:`lanczos` precise_sums).
    Full-f32 products over n-blocks summed in f64 keep the error at the
    sqrt(block)*eps level without an f64 copy of Vm."""
    if not jax.config.jax_enable_x64:
        return jnp.matmul(Vm, Vm.T, precision="highest")
    m, n = Vm.shape
    if n <= block:
        return jnp.matmul(Vm, Vm.T,
                          precision="highest").astype(jnp.float64)
    nb = -(-n // block)
    Vp = jnp.pad(Vm, ((0, 0), (0, nb * block - n)))
    chunks = jnp.transpose(Vp.reshape(m, nb, block), (1, 0, 2))

    def body(acc, C):
        g = jnp.matmul(C, C.T, precision="highest")
        return acc + g.astype(jnp.float64), None

    out, _ = jax.lax.scan(body, jnp.zeros((m, m), jnp.float64), chunks)
    return out


def matmul_f64(A, B):
    """A (m, n) @ B (n, t) in float64 (same precision rationale as
    :func:`gram_f64`); the compute dtype without x64 mode."""
    if not jax.config.jax_enable_x64:
        return jnp.matmul(A, B, precision="highest")
    return jnp.matmul(A.astype(jnp.float64), B.astype(jnp.float64),
                      precision="highest")


def ritz_decompose(alphas, betas):
    """Ritz values and SLQ weights from batched tridiagonal coefficients.

    Returns (theta (p, k), tau (p, k)) with tau the squared first
    components of T's eigenvectors — the Gauss quadrature weights of the
    Lanczos rule. Computed in float64 on host (tiny k x k problems).
    """
    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    p, k = a.shape
    theta = np.empty((p, k))
    tau = np.empty((p, k))
    for i in range(p):
        T = np.diag(a[i]) + np.diag(b[i], 1) + np.diag(b[i], -1)
        w, U = np.linalg.eigh(T)
        theta[i] = w
        tau[i] = U[0, :] ** 2
    return theta, tau


class StochasticTraceEngine:
    """One Lanczos pass over K; every eta and every f() amortized.

    The realization of imate.AffineMatrixFunction + SLQ
    (reference mixed_correlation.py:44,138-143,204-209,263-268), plus two
    variance-reduction layers the reference's backend lacks — both exploit
    the structure of correlation matrices (unit diagonal, fast-decaying
    spectrum):

    * **Top-q deflation**: a dedicated Lanczos run extracts converged top
      Ritz pairs (lam_i, w_i); their f-contribution is summed exactly and
      the probes are projected into the complement. Matern spectra decay
      fast, so the dominant variance source is removed entirely.
    * **Mean-shift control variate**: trace(K) = n exactly (unit
      diagonal), so the mean of the deflated remainder spectrum
      c = (n - sum lam_top)/(n - q) is *known*. The probes then only
      estimate trace(f(Kn) - f(c+eta) I) over the complement — a function
      with tiny dynamic range — while (n-q) f(c+eta) is added exactly.

    Together these cut the MC error by 1-2 orders of magnitude for the
    profile-likelihood derivative, whose root lives where the derivative
    is tiny (the reference documents this failure mode of plain
    stochastic traces at examples/CompareVariousNoiseLevel.py:4-9).
    """

    def __init__(self, K, num_probes=16, lanczos_steps=64, key=0,
                 reorthogonalize=True, probes=None, dtype=None,
                 deflate=64, deflate_steps=None, defer_lanczos=False):
        """``defer_lanczos=True`` prepares the (deflated, projected) probes
        and exact moments but skips the probe Lanczos pass; the caller runs
        its own batched Lanczos over ``self.probes`` (typically merged with
        other right-hand sides into ONE pass — see
        models.large_scale.KrylovProfileLikelihood) and hands the probe
        coefficients back through ``finalize(alphas, betas)``."""
        self.matvec = _as_matvec(K)
        self.n = K.shape[0]
        self.num_probes = num_probes
        self.lanczos_steps = min(lanczos_steps, self.n)
        dtype = dtype or compute_dtype()
        key = jax.random.PRNGKey(key)
        k_probe, k_defl = jax.random.split(key)

        # --- deflation basis ------------------------------------------------
        self.q = 0
        self.lam_top = np.zeros(0)
        W = None
        if deflate and deflate > 0 and self.n > 8:
            q_req = int(min(deflate, self.n // 2))
            kd = int(min(deflate_steps or (q_req + 24), self.n))
            v0 = jax.random.normal(k_defl, (self.n, 1), dtype=dtype)
            al, be, Vd = lanczos(self.matvec, v0, kd,
                                 reorthogonalize=reorthogonalize)
            a = np.asarray(al[0], dtype=np.float64)
            b = np.asarray(be[0], dtype=np.float64)
            T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
            w, U = np.linalg.eigh(T)
            # convergence: residual |beta_last * U[k-1, i]| small
            beta_last = abs(b[-1]) if kd > 1 else 0.0
            resid = beta_last * np.abs(U[-1, :])
            # converged Ritz pairs from BOTH spectral ends: the top drives
            # logdet variance, the bottom drives traceinv variance at
            # small eta
            order_hi = np.argsort(w)[::-1]
            order_lo = np.argsort(w)
            tol_r = 1e-3 * max(w[order_hi[0]], 1)
            keep_hi = [i for i in order_hi if resid[i] < tol_r]
            keep_lo = [i for i in order_lo if resid[i] < tol_r]
            keep, seen = [], set()
            for pair in zip(keep_hi, keep_lo):
                for i in pair:
                    if i not in seen:
                        seen.add(i)
                        keep.append(i)
            keep = keep[:q_req]
            if keep:
                self.q = len(keep)
                self.lam_top = w[keep]
                Uk = jnp.asarray(np.asarray(U[:, keep]), dtype=dtype)
                # Ritz vectors W = sum_k V_d[k] U[k, :]  -> (n, q),
                # re-orthonormalized (they are approximate)
                W = jnp.einsum("kn,kq->nq", Vd[:, 0], Uk)
                W, _ = jnp.linalg.qr(W)
        self.W = W

        # exact remainder moments: trace(K) = n (unit diagonal) and
        # trace(K^2) = ||K||_F^2 (computed once, O(n^2) fused work)
        if hasattr(K, "trace_pow"):
            trace_K2 = float(K.trace_pow(2))
        elif callable(K):
            trace_K2 = None
        else:
            trace_K2 = float(jnp.sum(jnp.asarray(K) ** 2))
        self.M0 = float(self.n - self.q)
        self.M1 = float(self.n - self.lam_top.sum())
        self.M2 = (None if trace_K2 is None
                   else float(trace_K2 - (self.lam_top ** 2).sum()))

        # --- probes in the complement --------------------------------------
        if probes is None:
            probes = jax.random.rademacher(
                k_probe, (self.n, num_probes), dtype=dtype)
        if W is not None:
            probes = probes - W @ (W.T @ probes)
        self.probes = probes
        self.probe_norm2 = np.asarray(
            jnp.sum(probes * probes, axis=0), dtype=np.float64)
        self._reorthogonalize = reorthogonalize
        self._dt = inference_dtype()

        if defer_lanczos:
            self.theta = None
            self.tau = None
        else:
            alphas, betas, _V = lanczos(self.matvec, probes,
                                        self.lanczos_steps,
                                        reorthogonalize=reorthogonalize)
            self.finalize(alphas, betas)

    def finalize(self, alphas, betas):
        """Install probe tridiagonal coefficients ((p, k), (p, k-1)) from
        an externally run Lanczos pass over ``self.probes``."""
        theta, tau = ritz_decompose(alphas, betas)
        # clip tiny negative Ritz values from f32 roundoff: K is PSD
        self.theta = np.maximum(theta, 0.0)
        self.tau = tau

    @classmethod
    def from_tridiagonals(cls, alphas, betas, probe_norm2, n,
                          trace_K2=None):
        """Minimal quadrature engine from externally computed probe
        tridiagonals — no deflation pass, no operator reference. Used by
        the grid-batched Krylov path (models.grid_krylov), where one
        batched Lanczos pass factorizes MANY kernels at once and each
        grid point gets its own lightweight engine. Assumes unit-diagonal
        K (trace(K) = n), as all correlation operators here have."""
        self = cls.__new__(cls)
        self.matvec = None
        self.n = int(n)
        self.num_probes = int(np.asarray(alphas).shape[0])
        self.lanczos_steps = int(np.asarray(alphas).shape[1])
        self.q = 0
        self.lam_top = np.zeros(0)
        self.W = None
        self.M0 = float(n)
        self.M1 = float(n)
        self.M2 = None if trace_K2 is None else float(trace_K2)
        self.probes = None
        self.probe_norm2 = np.asarray(probe_norm2, dtype=np.float64)
        self._reorthogonalize = True
        self._dt = inference_dtype()
        self.finalize(alphas, betas)
        return self

    def _quad(self, f, eta):
        """trace f(K + eta I): exact deflated part + regression-adjusted
        stochastic remainder.

        Per probe, the same Ritz pairs give joint estimates of
        (v'^T f(Kn) v', v'^T v', v'^T K v', v'^T K^2 v'); the latter three
        have *exactly known* expectations (M0, M1, M2), so a standard
        multi-control-variate regression removes the spectral-bulk
        variance that plain Hutchinson/SLQ keeps.
        """
        eta = float(eta)
        top = float(f(self.lam_top + eta).sum()) if self.q else 0.0

        F = self.probe_norm2 * (self.tau * f(self.theta + eta)).sum(axis=1)
        m0 = self.probe_norm2
        m1 = self.probe_norm2 * (self.tau * self.theta).sum(axis=1)
        covs = [(m0, self.M0), (m1, self.M1)]
        if self.M2 is not None:
            m2 = self.probe_norm2 * (self.tau * self.theta ** 2).sum(axis=1)
            covs.append((m2, self.M2))

        p = F.shape[0]
        Fc = F - F.mean()
        Xc = np.stack([c - c.mean() for c, _ in covs], axis=1)
        # ridge-regularized least squares for the CV coefficients
        G = Xc.T @ Xc
        G += 1e-12 * np.trace(G) / max(G.shape[0], 1) * np.eye(G.shape[0])
        beta = np.linalg.solve(G, Xc.T @ Fc)
        adjusted = F.mean() + sum(
            b * (target - c.mean()) for b, (c, target) in zip(beta, covs))
        return top + float(adjusted)

    def logdet(self, eta):
        return self._quad(lambda t: np.log(np.maximum(t, 1e-300)), eta)

    def traceinv(self, eta, exponent=1):
        return self._quad(lambda t: np.maximum(t, 1e-300) ** (-float(exponent)),
                          eta)

    def trace_pow(self, eta, exponent=1):
        return self._quad(lambda t: t ** exponent, eta)


def deflated_quadrature(al_defl, be_defl, al_probe, be_probe, P,
                        probe_norm2, n, trace_K2=None):
    """Collapse one-pass-deflated, CV-regressed SLQ into a fixed
    quadrature (nodes, weights): trace f(K + eta I) ~= sum_j w_j
    f(node_j + eta).

    Inputs come from ONE merged Lanczos pass over [.., v_defl, probes]:
    ``al_defl``/``be_defl`` the deflation chain's tridiagonal (k,)/(k-1,),
    ``al_probe``/``be_probe`` the probe tridiagonals (p, k)/(p, k-1),
    ``P`` (k, p) the probes' overlaps with the deflation chain's Lanczos
    basis, ``probe_norm2`` (p,) the squared probe norms.

    Math: converged Ritz pairs (mu_t, w_t) of the deflation chain are
    subtracted per probe — F_i - sum_t (v_i . w_t)^2 f(mu_t + eta) is
    unbiased for trace f - sum_t f(mu_t + eta) because
    E[(v^T w)^2] = |w|^2 for Rademacher probes even when w is NOT an
    exact eigenvector — then a control-variate regression against the
    exactly known moments trace(K^q) (q = 0: n, q = 1: n for
    unit-diagonal correlation K, q = 2: ||K||_F^2 if given) removes the
    spectral-bulk variance. Both corrections are linear in the per-probe
    quadratures, so they collapse into fixed weights. Replaces the
    separate deflation pass + runtime regression of
    StochasticTraceEngine for the single-factorization engines
    (models.large_scale, models.grid_krylov, models.krylov_posterior).
    """
    al_probe = np.asarray(al_probe, dtype=np.float64)
    be_probe = np.asarray(be_probe, dtype=np.float64)
    p, k = al_probe.shape
    probe_norm2 = np.asarray(probe_norm2, dtype=np.float64)

    theta, tau = ritz_decompose(al_probe, be_probe)
    theta = np.maximum(theta, 0.0)

    # deflation chain Ritz system
    a = np.asarray(al_defl, dtype=np.float64)
    b = np.asarray(be_defl, dtype=np.float64)
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    mu, Qd = np.linalg.eigh(T)
    mu = np.maximum(mu, 0.0)
    resid = (np.abs(b[-1]) * np.abs(Qd[-1, :])) if k > 1 else np.zeros(k)
    tol_r = 1e-3 * max(mu.max(), 1.0)
    order_hi = np.argsort(mu)[::-1]
    order_lo = np.argsort(mu)
    keep, seen = [], set()
    for pair in zip(order_hi, order_lo):
        for t in pair:
            if resid[t] < tol_r and t not in seen:
                seen.add(t)
                keep.append(t)
    keep = np.asarray(keep, dtype=int)
    q_b = keep.size
    mu_k = mu[keep]
    P = np.asarray(P, dtype=np.float64)
    vw = P.T @ Qd[:, keep] if q_b else np.zeros((p, 0))
    cit = vw ** 2                                          # (p, q_b)

    # CV regression on the deflated estimates -> fixed probe weights
    mq_raw = np.stack([
        probe_norm2 * tau.sum(axis=1),
        probe_norm2 * (tau * theta).sum(axis=1),
        probe_norm2 * (tau * theta ** 2).sum(axis=1),
    ], axis=1)                                             # (p, 3)
    mu_pows = np.stack([np.ones_like(mu_k), mu_k, mu_k ** 2], axis=1)
    mq = mq_raw - cit @ mu_pows
    n_mom = 3 if trace_K2 is not None else 2
    targets = np.array([float(n), float(n),
                        float(trace_K2) if trace_K2 is not None else 0.0])
    targets = targets[:n_mom] - mu_pows.sum(axis=0)[:n_mom]
    mq = mq[:, :n_mom]
    Xc = mq - mq.mean(axis=0, keepdims=True)
    Gm = Xc.T @ Xc
    Gm += 1e-12 * np.trace(Gm) / n_mom * np.eye(n_mom)
    Pm = np.linalg.solve(Gm, Xc.T)
    r = targets - mq.mean(axis=0)
    qw = Pm.T @ r
    omega = qw + (1.0 - qw.sum()) / p

    w_probe = omega[:, None] * probe_norm2[:, None] * tau   # (p, k)
    gamma = 1.0 - omega @ cit                               # (q_b,)
    nodes = np.concatenate([theta.ravel(), mu_k])
    weights = np.concatenate([w_probe.ravel(), gamma])
    return nodes, weights


class QuadratureTraceEngine:
    """Host-side trace engine over a fixed quadrature (nodes, weights):
    trace f(K + eta I) = sum_j w_j f(node_j + eta). The collapsed form of
    the deflated-CV SLQ estimator (see :func:`deflated_quadrature`) —
    the drop-in ``traces`` object of
    models.large_scale.KrylovProfileLikelihood."""

    def __init__(self, nodes, weights, n):
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.n = int(n)

    def _quad(self, f, eta):
        return float(np.sum(self.weights * f(self.nodes + float(eta))))

    def logdet(self, eta):
        return self._quad(lambda t: np.log(np.maximum(t, 1e-300)), eta)

    def traceinv(self, eta, exponent=1):
        return self._quad(
            lambda t: np.maximum(t, 1e-300) ** (-float(exponent)), eta)

    def trace_pow(self, eta, exponent=1):
        return self._quad(lambda t: t ** exponent, eta)


def hutchinson_traceinv(K, eta, num_probes=32, key=0, tol=1e-6,
                        max_iter=1000, exponent=1):
    """Hutchinson estimator of trace((K+eta I)^-p) via batched CG solves
    (the role of imate's 'hutchinson' method,
    reference mixed_correlation.py:193-202). All probes solve
    simultaneously as one multi-RHS CG.
    """
    from . import linalg
    n = K.shape[0]
    dtype = compute_dtype()
    V = jax.random.rademacher(jax.random.PRNGKey(key), (n, num_probes),
                              dtype=dtype)
    eta = jnp.asarray(eta, dtype=dtype)
    A = K.matmat if hasattr(K, "matmat") else jnp.asarray(K, dtype=dtype)
    X = linalg.cg_solve(A, V, tol=tol, max_iter=max_iter, shift=eta)
    if exponent == 2:
        X = linalg.cg_solve(A, X, tol=tol, max_iter=max_iter, shift=eta)
    elif exponent != 1:
        raise ValueError("exponent must be 1 or 2")
    est = jnp.sum(V * X, axis=0)
    return float(jnp.mean(est))
