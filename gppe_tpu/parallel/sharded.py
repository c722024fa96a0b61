"""Sharded kernels: row-block matvec and distributed Lanczos/profile step.

The multi-chip execution model (SURVEY.md §2.b, §5.7-5.8):

* operator rows, data vectors (z, X, probes) are sharded over the
  ``block`` mesh axis (the "tensor-parallel" axis of this domain);
* a matvec all-gathers the sharded Krylov vector along ``block``
  and multiplies the local row-block of the *never-materialized* Matern
  operator;
* inner products / norms are psums over ``block``;
* Hutchinson/SLQ probes split over the ``probe`` axis (the
  "data-parallel" axis) and only their final quadrature means are
  psum-averaged.

Everything below is shard_map-based so it compiles to one SPMD program
with explicit collectives, testable on a virtual CPU mesh.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import kernels, pallas_kernels
from .mesh import BLOCK_AXIS, PROBE_AXIS


def _rect_matern_matmat(pts_rows, pts_cols, scale, V, nu,
                        use_pallas=False):
    """Local row-block matvec: Matern(pts_rows, pts_cols) @ V, fused.

    ``use_pallas`` dispatches the fused GPU kernel in its rectangular
    form (ops.pallas_kernels.matern_matmat with ``points_cols`` — built
    for exactly this row-block-sharded use); the XLA form stays for CPU
    meshes and general nu."""
    if use_pallas:
        out = pallas_kernels.matern_matmat(pts_rows, scale, V, nu,
                                           points_cols=pts_cols)
        return out.astype(V.dtype)
    dist = kernels.pairwise_scaled_distance(pts_rows, pts_cols, scale)
    Kblk = kernels.matern(dist, nu)
    return jnp.matmul(Kblk, V, precision="highest")


def default_use_pallas(nu, mesh):
    """The fused local matvec choice (pallas_kernels.use_fused_kernel),
    keyed off the MESH's device platform rather than the default
    backend: a virtual CPU mesh takes the XLA path."""
    platform = next(iter(mesh.devices.flat)).platform
    return pallas_kernels.use_fused_kernel(nu, platform)


def ring_matern_matmat(pts_local, pts_full, scale, V_local, nu, axis,
                       n_blocks, use_pallas=False):
    """Ring-pipelined matvec with the Krylov vector kept SHARDED.

    The all-gather matvec materializes the full (n, r) vector on every
    chip each Lanczos step. Here V stays row-sharded: each of the
    ``n_blocks`` ring steps multiplies the local row-block of the
    never-materialized Matern operator against the currently-held column
    block and ``ppermute``s that block to the next neighbor, so per-device
    memory stays O(n/p) and XLA can overlap the transfer of step i+1
    with the product of step i (SURVEY.md §7 "hard parts": overlapped
    block-matvec collectives, not naive gather-per-step). The column
    *points* are NOT permuted: the points are replicated inputs already
    (``pts_full``), so the matching column block at ring step s is a
    local ``dynamic_slice`` at block index (my - s) mod n_blocks — only
    the Krylov block moves between devices.

    Must be called inside a shard_map with ``axis`` in scope.
    pts_local: (n_l, d); pts_full: (n, d) replicated; V_local: (n_l, r).
    Returns (n_l, r).
    """
    if n_blocks == 1:
        # degenerate ring: the self-permute [(0, 0)] communicates nothing
        return _rect_matern_matmat(pts_local, pts_local, scale, V_local,
                                   nu, use_pallas)
    perm = [(j, (j + 1) % n_blocks) for j in range(n_blocks)]
    n_l = V_local.shape[0]
    d = pts_local.shape[1]
    my = jax.lax.axis_index(axis)

    def body(step, carry):
        acc, V_rot = carry
        # block held at step s originated at chip (my - s) mod n_blocks
        src = jnp.mod(my - step, n_blocks).astype(jnp.int32)
        pts_cols = jax.lax.dynamic_slice(pts_full,
                                         (src * n_l, jnp.int32(0)),
                                         (n_l, d))
        blk = _rect_matern_matmat(pts_local, pts_cols, scale, V_rot, nu,
                                  use_pallas)
        V_rot = jax.lax.ppermute(V_rot, axis, perm)
        return acc + blk, V_rot

    acc = jnp.zeros_like(V_local)
    acc, _ = jax.lax.fori_loop(0, n_blocks, body, (acc, V_local))
    return acc


def _local_lanczos(matmat, V0_local, num_steps, axis):
    """Lanczos with vectors sharded over ``axis``; reductions are psums.

    V0_local: (n_local, r). Returns alphas (r, k), betas (r, k-1),
    V_store (k, n_local, r).
    """
    n_l, r = V0_local.shape
    dtype = V0_local.dtype
    k = num_steps

    def gsum(x):
        return jax.lax.psum(x, axis)

    nrm = jnp.sqrt(gsum(jnp.sum(V0_local * V0_local, axis=0)))
    q = V0_local / nrm
    V = jnp.zeros((k, n_l, r), dtype=dtype)
    V = V.at[0].set(q)
    alphas = jnp.zeros((r, k), dtype=dtype)
    betas = jnp.zeros((r, max(k - 1, 1)), dtype=dtype)

    def body(j, carry):
        V, alphas, betas, q, q_prev, beta_prev = carry
        w = matmat(q)
        alpha = gsum(jnp.sum(q * w, axis=0))
        w = w - alpha[None, :] * q - beta_prev[None, :] * q_prev
        # full reorthogonalization (local einsum + psum)
        mask = (jnp.arange(k) <= j).astype(dtype)
        coeffs = gsum(jnp.einsum("inp,np->ip", V, w,
                                 precision="highest")) * mask[:, None]
        w = w - jnp.einsum("inp,ip->np", V, coeffs, precision="highest")
        beta = jnp.sqrt(gsum(jnp.sum(w * w, axis=0)))
        beta_safe = jnp.where(beta > 0, beta, 1.0)
        q_next = w / beta_safe
        V = V.at[j + 1].set(jnp.where(j + 1 < k, q_next, V[j + 1]))
        alphas = alphas.at[:, j].set(alpha)
        betas = jax.lax.cond(j < k - 1,
                             lambda b: b.at[:, j].set(beta),
                             lambda b: b, betas)
        return (V, alphas, betas, q_next, q, beta)

    init = (V, alphas, betas, q, jnp.zeros_like(q),
            jnp.zeros(r, dtype=dtype))
    V, alphas, betas, *_ = jax.lax.fori_loop(0, k, body, init)
    return alphas, betas, V, nrm


def _tridiag_dense(alphas, betas):
    """(r, k), (r, k-1) -> batched dense (r, k, k) tridiagonal."""
    r, k = alphas.shape
    T = jnp.zeros((r, k, k), dtype=alphas.dtype)
    ii = jnp.arange(k)
    T = T.at[:, ii, ii].set(alphas)
    if k > 1:
        jj = jnp.arange(k - 1)
        T = T.at[:, jj, jj + 1].set(betas[:, :k - 1])
        T = T.at[:, jj + 1, jj].set(betas[:, :k - 1])
    return T


def build_sharded_profile_step(mesh, nu=0.5, lanczos_steps=16,
                               comm="ring", use_pallas=None):
    """Compile one full multi-chip profile-likelihood step.

    Returns a jitted fn(points_local..., see below) over the mesh that:
      1. runs the sharded Lanczos on the solve block [z, X] (replicated
         over 'probe', row-sharded over 'block'),
      2. runs the sharded Lanczos on the probe block (sharded over both),
      3. computes Ritz quadrature + Krylov solves for a *batch* of etas,
      4. returns der1(eta), traceinv(eta), logdet(eta) — replicated.

    This is the real multi-chip training-step graph: collectives along
    'block' inside every matvec, psum reductions for the Lanczos scalars,
    probe-mean psums along 'probe'.

    ``comm`` selects the matvec communication schedule:
      * ``'ring'`` (default) — ppermute ring pipelining; Krylov vectors
        stay sharded, per-chip memory O(n/p), transfer of block i+1
        overlaps the matmul of block i.
      * ``'allgather'`` — gather the full vector each step (simpler,
        materializes (n, r) per chip; the baseline schedule).

    ``use_pallas`` (default :func:`default_use_pallas`: GPU mesh +
    closed-form nu) runs the local row-block matvec through the fused
    GPU kernel.
    """
    if comm not in ("ring", "allgather"):
        raise ValueError(f"unknown comm schedule '{comm}'")
    if use_pallas is None:
        use_pallas = default_use_pallas(nu, mesh)
    k = lanczos_steps
    n_blocks = int(mesh.shape[BLOCK_AXIS])

    def step(points, scale, X, z, probes, etas):
        n, d = points.shape
        m = X.shape[1]
        s = m + 1

        def body(pts_l, pts_f, scale_, X_l, z_l, probes_l, etas_):
            rhs_l = jnp.concatenate([z_l[:, None], X_l], axis=1)  # (n_l, s)

            if comm == "ring":
                def matmat(V_l):
                    return ring_matern_matmat(pts_l, pts_f, scale_, V_l,
                                              nu, BLOCK_AXIS, n_blocks,
                                              use_pallas)
            else:
                def matmat(V_l):
                    V_f = jax.lax.all_gather(V_l, BLOCK_AXIS, axis=0,
                                             tiled=True)
                    return _rect_matern_matmat(pts_l, pts_f, scale_, V_f,
                                               nu, use_pallas)

            # 1) solve bases
            a_s, b_s, Vs, nrm_s = _local_lanczos(matmat, rhs_l, k,
                                                 BLOCK_AXIS)
            # 2) probe bases
            a_p, b_p, Vp, nrm_p = _local_lanczos(matmat, probes_l, k,
                                                 BLOCK_AXIS)

            # projections for the solve path (psum over block)
            U = jax.lax.psum(
                jnp.einsum("knj,nt->jkt", Vs, rhs_l), BLOCK_AXIS)
            Vm = jnp.transpose(Vs, (2, 0, 1)).reshape(s * k, -1)
            G = jax.lax.psum(Vm @ Vm.T, BLOCK_AXIS).reshape(
                s, k, s, k).transpose(0, 2, 1, 3)

            # Ritz quadrature of the probes (on-device batched eigh)
            T_p = _tridiag_dense(a_p, b_p)
            theta, Uev = jnp.linalg.eigh(T_p)          # (p_l, k), ...
            tau = Uev[:, 0, :] ** 2

            T_s = _tridiag_dense(a_s, b_s)             # (s, k, k)
            eye_k = jnp.eye(k, dtype=T_s.dtype)
            e1 = jnp.zeros((k,), dtype=T_s.dtype).at[0].set(1.0)

            def per_eta(eta):
                # solves y_j = (T_j + eta)^-1 ||b_j|| e1 — T_j + eta I is
                # SPD, so go through Cholesky
                L = jnp.linalg.cholesky(T_s + eta * eye_k)
                y = jax.scipy.linalg.cho_solve(
                    (L, True),
                    jnp.broadcast_to(e1, (s, k))[..., None])[..., 0]
                y = y * nrm_s[:, None]
                C = jnp.einsum("jkt,jk->tj", U, y)
                S2 = jnp.einsum("ia,ijab,jb->ij", y, G, y)
                B = C[1:, 1:]
                B = 0.5 * (B + B.T)
                Ytz = C[0, 1:]
                zw = C[0, 0]
                # B is a Krylov approximation — only symmetrized, not
                # guaranteed PD at low lanczos_steps / tiny eta; a
                # trace-relative jitter keeps the Cholesky from silently
                # yielding NaN where an LU would have limped through.
                jit_eps = 10.0 * jnp.finfo(B.dtype).eps
                B = B + (jit_eps * jnp.trace(B) / m) * jnp.eye(
                    m, dtype=B.dtype)
                L_B = jnp.linalg.cholesky(B)
                Binv = jax.scipy.linalg.cho_solve(
                    (L_B, True), jnp.eye(m, dtype=B.dtype))
                c = Binv @ Ytz
                zMz = zw - Ytz @ c
                zM2z = (S2[0, 0] - 2.0 * (S2[0, 1:] @ c)
                        + c @ (S2[1:, 1:] @ c))
                # probe-quadrature traces, psum-averaged over 'probe'.
                # Rademacher probes have ||v||^2 = n exactly, so each
                # normalized quadrature estimates trace/n.
                q_inv = (tau / (theta + eta)).sum(axis=1)
                q_log = (tau * jnp.log(theta + eta)).sum(axis=1)
                cnt = jax.lax.psum(jnp.asarray(
                    q_inv.shape[0], q_inv.dtype), PROBE_AXIS)
                traceinv = n * jax.lax.psum(q_inv.sum(), PROBE_AXIS) / cnt
                logdet = n * jax.lax.psum(q_log.sum(), PROBE_AXIS) / cnt
                trace_M = traceinv - jnp.trace(Binv @ S2[1:, 1:])
                sigma2 = zMz / (n - m)
                der1 = -0.5 * (trace_M - zM2z / sigma2)
                return der1, traceinv, logdet

            der1, traceinv, logdet = jax.vmap(per_eta)(etas_)
            return der1, traceinv, logdet

        pts_full = points
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(BLOCK_AXIS), P(), P(), P(BLOCK_AXIS),
                      P(BLOCK_AXIS), P(BLOCK_AXIS, PROBE_AXIS), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(points, pts_full, scale, X, z, probes, etas)

    return jax.jit(step)


def build_sharded_factorization(mesh, nu=0.5, lanczos_steps=64,
                                comm="ring", use_pallas=None):
    """Compile the ONE-time multi-chip Krylov factorization program.

    The multi-chip analog of models.large_scale.KrylovProfileLikelihood's
    setup: a single merged sharded Lanczos pass over the solve block
    [z, X], the deflation chain and the trace probes — all riding the
    same row-sharded matvecs (collectives along 'block' inside every
    matvec, probe chains sharded along 'probe') — followed by the small
    projections. Everything eta-dependent afterwards is host O(k^2) math
    (ShardedKrylovProfileLikelihood), so the FIT costs one device
    program no matter how many root-finding iterations follow.

    Returns a jitted fn(points, scale, X, z, v_defl, probes) ->
    (a_sd (s+1, k), b_sd (s+1, k-1), U (s, k, s), G (s, s, k, k),
    P (k, p), a_p (p, k), b_p (p, k-1), fro2) where column s of the
    solve block is the deflation chain and ``fro2`` is
    trace(K_padded^2) = ||K||_F^2 accumulated over the local row blocks
    (each chip pays O(n^2 / p_block); the caller subtracts the padded
    rows' unit diagonal). All projections are f64-accumulated
    (ops.stochastic.matmul_f64/gram_f64 — the r3 precision rule: f32
    O(n) reductions bias the per-eta math by ~sqrt(n)*eps).
    """
    from ..ops import stochastic

    if comm not in ("ring", "allgather"):
        raise ValueError(f"unknown comm schedule '{comm}'")
    if use_pallas is None:
        use_pallas = default_use_pallas(nu, mesh)
    k = lanczos_steps
    n_blocks = int(mesh.shape[BLOCK_AXIS])

    def fact(points, scale, X, z, v_defl, probes):
        m = X.shape[1]
        s = m + 1

        def body(pts_l, pts_f, scale_, X_l, z_l, vd_l, probes_l):
            solve_l = jnp.concatenate([z_l[:, None], X_l, vd_l], axis=1)

            if comm == "ring":
                def matmat(V_l):
                    return ring_matern_matmat(pts_l, pts_f, scale_, V_l,
                                              nu, BLOCK_AXIS, n_blocks,
                                              use_pallas)
            else:
                def matmat(V_l):
                    V_f = jax.lax.all_gather(V_l, BLOCK_AXIS, axis=0,
                                             tiled=True)
                    return _rect_matern_matmat(pts_l, pts_f, scale_, V_f,
                                               nu, use_pallas)

            # solve block + deflation chain (replicated over 'probe')
            a_sd, b_sd, Vsd, _ = _local_lanczos(matmat, solve_l, k,
                                                BLOCK_AXIS)
            # probe chains (sharded over 'probe')
            a_p, b_p, _Vp, _ = _local_lanczos(matmat, probes_l, k,
                                              BLOCK_AXIS)

            # f64-accumulated local projections, f64 psums over 'block'
            rhs_l = solve_l[:, :s]
            Vs = Vsd[:, :, :s]                          # (k, n_l, s)
            n_l = rhs_l.shape[0]
            U = jax.lax.psum(stochastic.matmul_f64(
                jnp.transpose(Vs, (0, 2, 1)).reshape(k * s, n_l),
                rhs_l).reshape(k, s, s), BLOCK_AXIS)
            U = jnp.transpose(U, (1, 0, 2))             # (s, k, s)
            Vm = jnp.transpose(Vs, (2, 0, 1)).reshape(s * k, n_l)
            G = jax.lax.psum(stochastic.gram_f64(Vm), BLOCK_AXIS)
            G = jnp.transpose(G.reshape(s, k, s, k), (0, 2, 1, 3))
            P = jax.lax.psum(stochastic.matmul_f64(
                Vsd[:, :, s], probes_l), BLOCK_AXIS)    # (k, p_l)

            # trace(K^2) = ||K||_F^2 over the LOCAL row block in column
            # tiles — distributed O(n^2 / p_block) riding the same SPMD
            # program (ADVICE r4: a single-device MaternOperator pass
            # here reintroduced exactly the one-chip O(n^2) bottleneck
            # the sharded factorization exists to avoid). Column padding
            # to the tile size uses mutually-far NEGATIVE offsets (the
            # row padding is far-positive), so every pad-vs-anything
            # kernel value is ~0 except each padded ROW's own unit
            # diagonal, which the caller subtracts.
            d_pts = pts_l.shape[1]
            cb = 512
            n_f = pts_f.shape[0]
            num_cb = -(-n_f // cb)
            pad_cols = num_cb * cb - n_f
            if pad_cols:
                far_neg = -1e6 * (2.0 + jnp.arange(pad_cols,
                                                   dtype=pts_f.dtype))
                pad_pts = jnp.zeros((pad_cols, d_pts),
                                    dtype=pts_f.dtype)
                pad_pts = pad_pts.at[:, 0].set(far_neg)
                cols_all = jnp.concatenate([pts_f, pad_pts], axis=0)
            else:
                cols_all = pts_f

            def fr_block(i):
                cols = jax.lax.dynamic_slice(
                    cols_all, (i * cb, jnp.zeros((), i.dtype)),
                    (cb, d_pts))
                dist = kernels.pairwise_scaled_distance(pts_l, cols,
                                                        scale_)
                Kblk = kernels.matern(dist, nu)
                return jnp.sum(Kblk * Kblk)

            fro2 = jnp.sum(jax.lax.map(fr_block, jnp.arange(num_cb)))
            fro2 = jax.lax.psum(fro2, BLOCK_AXIS)
            return a_sd, b_sd, U, G, P, a_p, b_p, fro2

        pts_full = points
        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(BLOCK_AXIS), P(), P(), P(BLOCK_AXIS),
                      P(BLOCK_AXIS), P(BLOCK_AXIS),
                      P(BLOCK_AXIS, PROBE_AXIS)),
            out_specs=(P(), P(), P(), P(), P(None, PROBE_AXIS),
                       P(PROBE_AXIS), P(PROBE_AXIS), P()),
            check_vma=False,
        )(points, pts_full, scale, X, z, v_defl, probes)

    return jax.jit(fact)


class ShardedKrylovProfileLikelihood:
    """End-to-end profile-likelihood MLE over a device mesh.

    The multi-chip equivalent of the reference's full root-finding
    driver (reference _profile_likelihood.py:244-415): ONE sharded
    Krylov factorization program on the mesh (build_sharded_factorization
    — row-block-sharded fused matvecs, ring/allgather schedules, probe
    chains on the 'probe' axis), then the entire MLE — bracket search,
    Chandrupatla root-finding, der2-at-0 boundary-sign analysis and the
    exact-OLS eta->inf boundary — runs on the host O(k^2) engine
    (models.large_scale.KrylovProfileLikelihood.from_factorization).
    Root-finding costs microseconds per eta; no further device programs.

    ``n`` need not divide the mesh's block extent: points are padded
    with mutually-far dummy points and the data block with zero rows —
    the padded operator is block-diagonal with ~identity on the pad
    block, and zero-padded Krylov vectors stay zero there, so the
    factorization is EXACTLY the unpadded one.
    """

    def __init__(self, mesh, points, X, z, scale, nu=0.5,
                 lanczos_steps=64, num_probes=16, comm="ring", key=0,
                 use_pallas=None, trace_k2=True, dtype=None):
        import numpy as np
        from ..models.large_scale import KrylovProfileLikelihood
        from ..ops import stochastic
        from ..utils.config import (compute_dtype,
                                    ensure_inference_precision)

        # the host per-eta engine and the accumulated projections are
        # float64 (the r3 precision rule); the O(n) device math stays in
        # compute dtype
        ensure_inference_precision()
        dtype = dtype or compute_dtype()
        pts = np.asarray(points, dtype=np.float64)
        X = np.asarray(X, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        n, d = pts.shape
        m = X.shape[1]
        self.n, self.m = n, m
        s = m + 1
        k = int(min(lanczos_steps, n))
        p = int(num_probes)
        probe_ext = int(mesh.shape[PROBE_AXIS])
        block_ext = int(mesh.shape[BLOCK_AXIS])
        if p % probe_ext:
            p = -(-p // probe_ext) * probe_ext   # round up to the mesh

        # pad n up to a block-extent multiple (see class docstring)
        n_pad = -(-n // block_ext) * block_ext
        if n_pad > n:
            far = 1e6 * (2.0 + np.arange(n_pad - n))
            pts_pad = np.zeros((n_pad, d))
            pts_pad[:n] = pts
            pts_pad[n:, 0] = far
            pts = pts_pad
        zp = np.zeros(n_pad)
        zp[:n] = z
        Xp = np.zeros((n_pad, m))
        Xp[:n] = X

        rng = jax.random.PRNGKey(key)
        k_probe, k_defl = jax.random.split(rng)
        probes = np.zeros((n_pad, p), dtype=np.float64)
        probes[:n] = np.asarray(jax.random.rademacher(
            k_probe, (n, p), dtype=jnp.float32), dtype=np.float64)
        v_defl = np.zeros((n_pad, 1), dtype=np.float64)
        v_defl[:n, 0] = np.asarray(jax.random.normal(
            k_defl, (n,), dtype=jnp.float32), dtype=np.float64)

        fact = build_sharded_factorization(
            mesh, nu=nu, lanczos_steps=k, comm=comm,
            use_pallas=use_pallas)
        out = fact(jnp.asarray(pts, dtype),
                   jnp.asarray(np.broadcast_to(np.asarray(scale, float),
                                               (d,)).copy(), dtype),
                   jnp.asarray(Xp, dtype), jnp.asarray(zp, dtype),
                   jnp.asarray(v_defl, dtype),
                   jnp.asarray(probes, dtype))
        a_sd, b_sd, U, G, P, a_p, b_p, fro2 = (
            np.asarray(o, dtype=np.float64) for o in out)

        A = np.concatenate([z[:, None], X], axis=1)
        rhs_norms = np.linalg.norm(A, axis=0)
        tK2 = None
        if trace_k2:
            # trace(K^2) arrives from the sharded program itself
            # (distributed column-tiled Frobenius — ADVICE r4); each
            # padded row contributes exactly its unit diagonal
            tK2 = float(fro2) - (n_pad - n)
        nodes, weights = stochastic.deflated_quadrature(
            a_sd[s], b_sd[s], a_p, b_p, P,
            np.full(p, float(n)), n, trace_K2=tK2)
        traces = stochastic.QuadratureTraceEngine(nodes, weights, n)
        self._eng = KrylovProfileLikelihood.from_factorization(
            a_sd[:s], b_sd[:s], U, G, rhs_norms, traces, n, m,
            AtA=A.T @ A)

    # host O(k^2) per-eta surface (delegates)
    def der1(self, log_eta):
        return self._eng.der1(log_eta)

    def der2(self, eta):
        return self._eng.der2(eta)

    def log_likelihood(self, sigma, eta):
        return self._eng.log_likelihood(sigma, eta)

    def fit(self, **kwargs):
        """Full MLE: bracket + Chandrupatla + boundary fallback — see
        KrylovProfileLikelihood.fit."""
        return self._eng.fit(**kwargs)
