"""SH block-tridiagonal assembly vs a dense-matrix oracle.

Builds the spherical-harmonics linear system twice for random physical
inputs: (a) as a dense matrix following the banded-storage index relation
of the reference fill (fluxes.py:3274-3301 for 2-stream, :3462-3543 for
4-stream, entry M[i,j] at Mb[u+i-j, j]), and (b) through picaso_tpu's
block-tridiagonal path — and checks the solutions agree.  This pins the
JAX solver to the reference system definition without needing scipy's
banded solver in the hot path.
"""

import numpy as np
import jax.numpy as jnp

from picaso_tpu.constants import PI
from picaso_tpu.rt.sh import (_sh2_system, _sh4_system, _solve_sh)


def _dense_from_blocks(A, B, C, n, s, w):
    M = np.zeros((n * s, n * s))
    for k in range(n):
        M[k * s:(k + 1) * s, k * s:(k + 1) * s] = B[k, :, :, w]
        if k > 0:
            M[k * s:(k + 1) * s, (k - 1) * s:k * s] = A[k, :, :, w]
        if k < n - 1:
            M[k * s:(k + 1) * s, (k + 1) * s:(k + 2) * s] = C[k, :, :, w]
    return M


def _random_inputs(stream, seed=0, nlayer=7, nwno=3):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.3, 0.999, (nlayer, nwno))
    dtau = rng.uniform(0.05, 1.5, (nlayer, nwno))
    tau = np.zeros((nlayer + 1, nwno))
    tau[1:] = np.cumsum(dtau, axis=0)
    cosb = rng.uniform(0.0, 0.9, (nlayer, nwno))
    w_multi = np.stack([(2 * l + 1) * cosb ** l for l in range(stream)])
    a = np.stack([(2 * l + 1) - w0 * w_multi[l] for l in range(stream)])
    u0 = 0.5773
    Pu0 = [1.0, -u0, (3 * u0 ** 2 - 1) / 2, (-5 * u0 ** 3 + 3 * u0) / 2]
    F0PI = np.ones(nwno)
    b = np.stack([(F0PI * w0 * w_multi[l]) * Pu0[l] / (4 * PI)
                  for l in range(stream)])
    surf_reflect = np.zeros(nwno) + 0.1
    b_top = 0.0
    b_surface = 0.0 + surf_reflect * u0 * F0PI * np.exp(-tau[-1] / u0)
    b_surface_sh4 = -b_surface / 4
    return (w0, dtau, tau, a, b, b_top, b_surface, b_surface_sh4,
            surf_reflect, u0)


def _reference_dense_2stream(w0, dtau, tau, a, b, b_top, b_surface,
                             surf_reflect, u0, w):
    """Dense M, B for one wavelength, from the fluxes.py:3238-3301 recipe."""
    nlayer, nwno = dtau.shape
    Del = (1 / u0) ** 2 - a[0] * a[1]
    eta = [(b[1] / u0 - a[1] * b[0]) / Del, (b[0] / u0 - a[0] * b[1]) / Del]
    lam = np.sqrt(a[0] * a[1])
    exptrm = np.exp(-np.clip(lam * dtau, -35, 35))
    q = lam / a[1]
    Q1 = (0.5 + q) * 2 * PI
    Q2 = (0.5 - q) * 2 * PI
    Q1mn, Q2mn = Q1 * exptrm, Q2 * exptrm
    Q1pl, Q2pl = Q1 / exptrm, Q2 / exptrm
    zmn = (0.5 * eta[0] - eta[1]) * 2 * PI
    zpl = (0.5 * eta[0] + eta[1]) * 2 * PI
    expon = np.exp(-tau / u0)
    zmn_up, zpl_up = zmn * expon[1:], zpl * expon[1:]
    zmn_down, zpl_down = zmn * expon[:-1], zpl * expon[:-1]

    Mb = np.zeros((5, 2 * nlayer))
    Bv = np.zeros(2 * nlayer)
    Mb[2, 0] = Q1[0, w]
    Mb[1, 1] = Q2[0, w]
    Bv[0] = b_top - zmn_down[0, w]
    n = nlayer - 1
    Mb[3, 2 * nlayer - 2] = Q2mn[n, w] - surf_reflect[w] * Q1mn[n, w]
    Mb[2, 2 * nlayer - 1] = Q1pl[n, w] - surf_reflect[w] * Q2pl[n, w]
    Bv[2 * nlayer - 1] = (b_surface[w] - zpl_up[n, w]
                          + surf_reflect[w] * zmn_up[n, w])
    Mb[0, 3::2] = -Q2[1:, w]
    Mb[1, 2::2] = -Q1[1:, w]
    Mb[1, 3::2] = -Q1[1:, w]
    Mb[2, 1:-1:2] = Q2pl[:-1, w]
    Mb[2, 2::2] = -Q2[1:, w]
    Mb[3, :-2:2] = Q1mn[:-1, w]
    Mb[3, 1:-1:2] = Q1pl[:-1, w]
    Mb[4, :-2:2] = Q2mn[:-1, w]
    Bv[1:-1:2] = zmn_down[1:, w] - zmn_up[:-1, w]
    Bv[2::2] = zpl_down[1:, w] - zpl_up[:-1, w]

    N = 2 * nlayer
    M = np.zeros((N, N))
    for d in range(5):
        for j in range(N):
            i = j + d - 2
            if 0 <= i < N:
                M[i, j] = Mb[d, j]
    return M, Bv


def _reference_dense_4stream(w0, dtau, tau, a, b, b_top, b_surface,
                             b_surface_sh4, surf_reflect, u0, w):
    """Dense M, B for one wavelength per fluxes.py:3386-3543."""
    nlayer, nwno = dtau.shape
    beta = a[0] * a[1] + 4 * a[0] * a[3] / 9 + a[2] * a[3] / 9
    gama = a[0] * a[1] * a[2] * a[3] / 9
    lam1 = np.sqrt((beta + np.sqrt(beta ** 2 - 4 * gama)) / 2)
    lam2 = np.sqrt((beta - np.sqrt(beta ** 2 - 4 * gama)) / 2)
    Del = 9 * ((1 / u0) ** 4 - beta * (1 / u0) ** 2 + gama)
    Dels = np.zeros((4, nlayer, nwno))
    Dels[0] = ((a[1] * b[0] - b[1] / u0) * (a[2] * a[3] - 9 / u0 ** 2)
               + 2 * (a[3] * b[2] - 2 * a[3] * b[0] - 3 * b[3] / u0)
               / u0 ** 2)
    Dels[1] = ((a[0] * b[1] - b[0] / u0) * (a[2] * a[3] - 9 / u0 ** 2)
               - 2 * a[0] * (a[3] * b[2] - 3 * b[3] / u0) / u0)
    Dels[2] = ((a[3] * b[2] - 3 * b[3] / u0) * (a[0] * a[1] - 1 / u0 ** 2)
               - 2 * a[3] * (a[0] * b[1] - b[0] / u0) / u0)
    Dels[3] = ((a[2] * b[3] - 3 * b[2] / u0) * (a[0] * a[1] - 1 / u0 ** 2)
               + 2 * (3 * a[0] * b[1] - 2 * a[0] * b[3] - 3 * b[0] / u0)
               / u0 ** 2)
    eta = Dels / Del
    z1pl = (eta[0] / 2 + eta[1] + 5 * eta[2] / 8) * 2 * PI
    z1mn = (eta[0] / 2 - eta[1] + 5 * eta[2] / 8) * 2 * PI
    z2pl = (-eta[0] / 8 + 5 * eta[2] / 8 + eta[3]) * 2 * PI
    z2mn = (-eta[0] / 8 + 5 * eta[2] / 8 - eta[3]) * 2 * PI
    exptrm1 = np.exp(-np.clip(lam1 * dtau, -35, 35))
    exptrm2 = np.exp(-np.clip(lam2 * dtau, -35, 35))
    R1, R2 = -a[0] / lam1, -a[0] / lam2
    Q1 = 0.5 * (a[0] * a[1] / lam1 ** 2 - 1)
    Q2 = 0.5 * (a[0] * a[1] / lam2 ** 2 - 1)
    S1 = -3 / (2 * a[3]) * (a[0] * a[1] / lam1 - lam1)
    S2 = -3 / (2 * a[3]) * (a[0] * a[1] / lam2 - lam2)
    p1pl = (0.5 + R1 + 5 * Q1 / 8) * 2 * PI
    p2pl = (0.5 + R2 + 5 * Q2 / 8) * 2 * PI
    q1pl = (-0.125 + 5 * Q1 / 8 + S1) * 2 * PI
    q2pl = (-0.125 + 5 * Q2 / 8 + S2) * 2 * PI
    p1mn = (0.5 - R1 + 5 * Q1 / 8) * 2 * PI
    p2mn = (0.5 - R2 + 5 * Q2 / 8) * 2 * PI
    q1mn = (-0.125 + 5 * Q1 / 8 - S1) * 2 * PI
    q2mn = (-0.125 + 5 * Q2 / 8 - S2) * 2 * PI
    f00, f01, f02, f03 = (p1mn * exptrm1, p1pl / exptrm1, p2mn * exptrm2,
                          p2pl / exptrm2)
    f10, f11, f12, f13 = (q1mn * exptrm1, q1pl / exptrm1, q2mn * exptrm2,
                          q2pl / exptrm2)
    f20, f21, f22, f23 = (p1pl * exptrm1, p1mn / exptrm1, p2pl * exptrm2,
                          p2mn / exptrm2)
    f30, f31, f32, f33 = (q1pl * exptrm1, q1mn / exptrm1, q2pl * exptrm2,
                          q2mn / exptrm2)
    expon = np.exp(-np.clip(tau / u0, -35, 35))
    z1mn_up, z2mn_up = z1mn * expon[1:], z2mn * expon[1:]
    z1pl_up, z2pl_up = z1pl * expon[1:], z2pl * expon[1:]
    z1mn_down, z2mn_down = z1mn * expon[:-1], z2mn * expon[:-1]
    z1pl_down, z2pl_down = z1pl * expon[:-1], z2pl * expon[:-1]

    R = surf_reflect
    Mb = np.zeros((11, 4 * nlayer))
    Bv = np.zeros(4 * nlayer)
    Mb[5, 0] = p1mn[0, w]
    Mb[5, 1] = q1pl[0, w]
    Mb[4, 1] = p1pl[0, w]
    Mb[4, 2] = q2mn[0, w]
    Mb[3, 2] = p2mn[0, w]
    Mb[3, 3] = q2pl[0, w]
    Mb[2, 3] = p2pl[0, w]
    Mb[6, 0] = q1mn[0, w]
    Bv[0] = b_top - z1mn_down[0, w]
    Bv[1] = -b_top / 4 - z2mn_down[0, w]
    n = nlayer - 1
    Mb[5, 4 * nlayer - 2] = f22[n, w] - R[w] * f02[n, w]
    Mb[5, 4 * nlayer - 1] = f33[n, w] - R[w] * f13[n, w]
    Mb[4, 4 * nlayer - 1] = f23[n, w] - R[w] * f03[n, w]
    Mb[6, 4 * nlayer - 3] = f21[n, w] - R[w] * f01[n, w]
    Mb[6, 4 * nlayer - 2] = f32[n, w] - R[w] * f12[n, w]
    Mb[7, 4 * nlayer - 4] = f20[n, w] - R[w] * f00[n, w]
    Mb[7, 4 * nlayer - 3] = f31[n, w] - R[w] * f11[n, w]
    Mb[8, 4 * nlayer - 4] = f30[n, w] - R[w] * f10[n, w]
    Bv[4 * nlayer - 2] = (b_surface[w] - z1pl_up[n, w]
                          + R[w] * z1mn_up[n, w])
    Bv[4 * nlayer - 1] = (b_surface_sh4[w] - z2pl_up[n, w]
                          + R[w] * z2mn_up[n, w])
    Mb[5, 2:-4:4] = f02[:-1, w]
    Mb[5, 3:-4:4] = f13[:-1, w]
    Mb[5, 4::4] = -p1pl[1:, w]
    Mb[5, 5::4] = -q1mn[1:, w]
    Mb[4, 3:-4:4] = f03[:-1, w]
    Mb[4, 4::4] = -q1mn[1:, w]
    Mb[4, 5::4] = -p1mn[1:, w]
    Mb[4, 6::4] = -q2pl[1:, w]
    Mb[3, 4::4] = -p1mn[1:, w]
    Mb[3, 5::4] = -q1pl[1:, w]
    Mb[3, 6::4] = -p2pl[1:, w]
    Mb[3, 7::4] = -q2mn[1:, w]
    Mb[2, 5::4] = -p1pl[1:, w]
    Mb[2, 6::4] = -q2mn[1:, w]
    Mb[2, 7::4] = -p2mn[1:, w]
    Mb[1, 6::4] = -p2mn[1:, w]
    Mb[1, 7::4] = -q2pl[1:, w]
    Mb[0, 7::4] = -p2pl[1:, w]
    Mb[6, 1:-4:4] = f01[:-1, w]
    Mb[6, 2:-4:4] = f12[:-1, w]
    Mb[6, 3:-4:4] = f23[:-1, w]
    Mb[6, 4::4] = -q1pl[1:, w]
    Mb[7, 0:-4:4] = f00[:-1, w]
    Mb[7, 1:-4:4] = f11[:-1, w]
    Mb[7, 2:-4:4] = f22[:-1, w]
    Mb[7, 3:-4:4] = f33[:-1, w]
    Mb[8, 0:-4:4] = f10[:-1, w]
    Mb[8, 1:-4:4] = f21[:-1, w]
    Mb[8, 2:-4:4] = f32[:-1, w]
    Mb[9, 0:-4:4] = f20[:-1, w]
    Mb[9, 1:-4:4] = f31[:-1, w]
    Mb[10, 0:-4:4] = f30[:-1, w]
    Bv[2:-4:4] = z1mn_down[1:, w] - z1mn_up[:-1, w]
    Bv[3:-4:4] = z2mn_down[1:, w] - z2mn_up[:-1, w]
    Bv[4::4] = z1pl_down[1:, w] - z1pl_up[:-1, w]
    Bv[5::4] = z2pl_down[1:, w] - z2pl_up[:-1, w]

    N = 4 * nlayer
    M = np.zeros((N, N))
    for d in range(11):
        for j in range(N):
            i = j + d - 5
            if 0 <= i < N:
                M[i, j] = Mb[d, j]
    return M, Bv


def test_sh2_solution_matches_reference_system():
    (w0, dtau, tau, a, b, b_top, b_surface, _, surf_reflect,
     u0) = _random_inputs(2)
    # new API: angle axis nr=1 on b / b_surface / ubar0
    T, Fm, z_down, z_up, btv, bsv, aux = _sh2_system(
        jnp.asarray(w0), jnp.asarray(dtau), jnp.asarray(tau),
        jnp.asarray(a), jnp.asarray(b)[:, None], b_top,
        jnp.asarray(b_surface)[None], jnp.asarray(surf_reflect),
        jnp.asarray([u0]), 0)
    X = np.asarray(_solve_sh(T, Fm, z_down, z_up, btv, bsv,
                             jnp.asarray(surf_reflect), 2)[:, :, 0])
    # the JAX system solves for the per-layer SCALED growing-mode
    # coefficient X2' = X2/exptrm (f32 conditioning); unscale to compare
    # against the reference's unscaled unknowns
    X = X.copy()
    X[:, 1] = X[:, 1] * np.asarray(aux['exptrm'])
    for w in range(dtau.shape[1]):
        M, Bv = _reference_dense_2stream(w0, dtau, tau, a, b, b_top,
                                         b_surface, surf_reflect, u0, w)
        expect = np.linalg.solve(M, Bv)
        got = X[:, :, w].reshape(-1)
        np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-12)


def test_sh4_solution_matches_reference_system():
    (w0, dtau, tau, a, b, b_top, b_surface, b_surface_sh4, surf_reflect,
     u0) = _random_inputs(4, seed=5)
    T, Fm, z_down, z_up, btv, bsv, aux = _sh4_system(
        jnp.asarray(w0), jnp.asarray(dtau), jnp.asarray(tau),
        jnp.asarray(a), jnp.asarray(b)[:, None], b_top,
        jnp.asarray(b_surface)[None], jnp.asarray(b_surface_sh4)[None],
        jnp.asarray(surf_reflect), jnp.asarray([u0]), 0)
    X = np.asarray(_solve_sh(T, Fm, z_down, z_up, btv, bsv,
                             jnp.asarray(surf_reflect), 4)[:, :, 0])
    X = X.copy()
    X[:, 1] = X[:, 1] * np.asarray(aux['exptrm1'])
    X[:, 3] = X[:, 3] * np.asarray(aux['exptrm2'])
    for w in range(dtau.shape[1]):
        M, Bv = _reference_dense_4stream(w0, dtau, tau, a, b, b_top,
                                         b_surface, b_surface_sh4,
                                         surf_reflect, u0, w)
        expect = np.linalg.solve(M, Bv)
        got = X[:, :, w].reshape(-1)
        np.testing.assert_allclose(got, expect, rtol=1e-7, atol=1e-12)
