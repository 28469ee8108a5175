"""Tests for the side towers: tensors, POD, optimization, marching
tetrahedra visualization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import create_grid, sphere
from levelsetpy_tpu.tensors import (KruskalTensor, TuckerTensor, cp_als,
                                    dematricize, hosvd, khatri_rao, kron,
                                    matricize, mode_n_product,
                                    multi_mode_product, nvecs, tucker_als)
from levelsetpy_tpu.pod import (SolverL2, SolverL2Decoupled, SolverTikhonov,
                                SolverTikhonovDecoupled, cumulative_energy,
                                pod_basis, projection_error, svdval_decay,
                                xdot_nonuniform, xdot_uniform)
from levelsetpy_tpu.optim import admm_lasso, chambolle_pock_tv
from levelsetpy_tpu.viz.marching import (contour_segments, implicit_mesh,
                                         marching_tetrahedra)


class TestTensors:
    def test_mode_n_product_matches_unfold(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((4, 5, 6)))
        m = jnp.asarray(rng.standard_normal((7, 5)))
        out = mode_n_product(x, m, 1)
        assert out.shape == (4, 7, 6)
        expect = dematricize(m @ matricize(x, 1), (4, 7, 6), 1)
        np.testing.assert_allclose(out, expect, atol=1e-12)

    def test_matricize_roundtrip(self):
        x = jnp.arange(24.0).reshape(2, 3, 4)
        for mode in range(3):
            m = matricize(x, mode)
            np.testing.assert_allclose(dematricize(m, x.shape, mode), x)

    def test_kron_khatri_rao(self):
        a = jnp.arange(4.0).reshape(2, 2)
        b = jnp.eye(2)
        assert kron(a, b).shape == (4, 4)
        kr = khatri_rao([a, b])
        assert kr.shape == (4, 2)
        np.testing.assert_allclose(kr[:, 0], jnp.kron(a[:, 0], b[:, 0]))

    def test_hosvd_exact_for_low_rank(self):
        rng = np.random.default_rng(1)
        u = [jnp.asarray(rng.standard_normal((s, 2))) for s in (6, 7, 8)]
        core = jnp.asarray(rng.standard_normal((2, 2, 2)))
        x = multi_mode_product(core, u)  # expand: contract rank dims
        tt = hosvd(x, (2, 2, 2))
        np.testing.assert_allclose(tt.to_dense(), x, atol=1e-10)

    def test_tucker_als_improves_or_matches(self):
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((6, 7, 8)))
        t0 = hosvd(x, (3, 3, 3))
        t1 = tucker_als(x, (3, 3, 3), n_iters=10)
        e0 = float(jnp.linalg.norm(t0.to_dense() - x))
        e1 = float(jnp.linalg.norm(t1.to_dense() - x))
        assert e1 <= e0 + 1e-8

    def test_cp_als_recovers_rank1(self):
        a = jnp.array([1.0, 2.0, 3.0])
        b = jnp.array([1.0, -1.0])
        c = jnp.array([2.0, 0.5, 1.0, -1.0])
        x = jnp.einsum("a,b,c->abc", a, b, c)
        kt = cp_als(x, rank=1, n_iters=30)
        np.testing.assert_allclose(kt.to_dense(), x, atol=1e-6)

    def test_nvecs_orthonormal(self):
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal((5, 6, 7)))
        v = nvecs(x, 0, 3)
        np.testing.assert_allclose(v.T @ v, jnp.eye(3), atol=1e-10)


class TestPOD:
    def test_pod_basis_rank(self):
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.standard_normal((20, 10)))
        vr, s = pod_basis(x, r=4)
        assert vr.shape == (20, 4)
        np.testing.assert_allclose(vr.T @ vr, jnp.eye(4), atol=1e-10)

    def test_pod_energy_threshold(self):
        u = jnp.eye(10)
        s = jnp.array([10.0, 1.0, 0.1] + [1e-12] * 7)
        x = u * s  # diag
        vr, sv = pod_basis(x, energy=0.99)
        assert vr.shape[1] <= 2

    def test_svdval_decay_and_energy(self):
        s = jnp.array([10.0, 5.0, 1.0, 1e-8])
        assert svdval_decay(s, 1e-6) == 3
        assert cumulative_energy(s, 0.79) == 1

    def test_projection_error_zero_for_spanning_basis(self):
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.standard_normal((8, 3)))
        vr, _ = pod_basis(x, r=3)
        assert float(projection_error(x, vr)) < 1e-10

    def test_randomized_svd_subspace_angles_on_solve_snapshots(self):
        """Halko sketch vs dense SVD on a REAL solve snapshot matrix
        (top-k subspace angles must agree)."""
        import jax.numpy as jnp

        from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                    cylinder, solve)
        from levelsetpy_tpu.pod import pod_basis, randomized_svd

        g = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], 15,
                        periodic_dims=[2])
        target = cylinder(g, ignore_axes=[2], radius=5.0,
                          dtype=jnp.float64)
        res = solve(g, DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0), target,
                    tau=jnp.linspace(0.0, 0.6, 13),
                    cfg=SchemeConfig(accuracy="eno2", rk_order=2))
        x = jnp.stack([v.ravel() for v in res.values], axis=1)  # n x 13
        k = 5
        v_dense, s_dense = pod_basis(x, r=k)
        v_rand, s_rand = pod_basis(x, r=k, method="randomized")
        # principal angles between the two k-dim subspaces: all ~0
        cos = np.linalg.svd(np.asarray(v_dense.T @ v_rand),
                            compute_uv=False)
        assert cos.min() > 1 - 1e-8, cos
        np.testing.assert_allclose(s_rand, s_dense[:k], rtol=1e-8)
        # direct API + orthonormality
        u, s, vt = randomized_svd(x, k)
        np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-10)
        recon = u @ (s[:, None] * vt)
        proj = np.asarray(v_dense @ (v_dense.T @ x))
        np.testing.assert_allclose(recon, proj, atol=1e-7)

    def test_randomized_requires_rank(self):
        import pytest

        from levelsetpy_tpu.pod import pod_basis

        with pytest.raises(ValueError, match="rank r"):
            pod_basis(jnp.zeros((8, 4)), energy=0.9, method="randomized")
        with pytest.raises(ValueError, match="unknown POD method"):
            pod_basis(jnp.zeros((8, 4)), r=2, method="magic")

    def test_solver_l2_matches_lstsq_at_zero_reg(self):
        rng = np.random.default_rng(6)
        a = jnp.asarray(rng.standard_normal((12, 4)))
        b = jnp.asarray(rng.standard_normal((12,)))
        x = SolverL2().fit(a, b).predict(0.0)
        expect = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0]
        np.testing.assert_allclose(x, expect, atol=1e-8)

    def test_solver_l2_regularization_shrinks(self):
        rng = np.random.default_rng(7)
        a = jnp.asarray(rng.standard_normal((12, 4)))
        b = jnp.asarray(rng.standard_normal((12,)))
        s = SolverL2().fit(a, b)
        x0, x1 = s.predict(0.0), s.predict(10.0)
        assert float(jnp.linalg.norm(x1)) < float(jnp.linalg.norm(x0))

    def test_tikhonov_matches_l2_for_scalar(self):
        rng = np.random.default_rng(8)
        a = jnp.asarray(rng.standard_normal((10, 3)))
        b = jnp.asarray(rng.standard_normal((10, 2)))
        lam = 0.7
        x_l2 = SolverL2().fit(a, b).predict(lam)
        x_tik = SolverTikhonov().fit(a, b).predict(lam)
        np.testing.assert_allclose(x_l2, x_tik, atol=1e-8)

    def test_decoupled_solvers(self):
        rng = np.random.default_rng(9)
        a = jnp.asarray(rng.standard_normal((10, 3)))
        b = jnp.asarray(rng.standard_normal((10, 2)))
        lams = jnp.array([0.1, 2.0])
        xd = SolverL2Decoupled().fit(a, b).predict(lams)
        x0 = SolverL2().fit(a, b[:, 0]).predict(0.1)
        x1 = SolverL2().fit(a, b[:, 1]).predict(2.0)
        np.testing.assert_allclose(xd[:, 0], x0, atol=1e-9)
        np.testing.assert_allclose(xd[:, 1], x1, atol=1e-9)
        xtd = SolverTikhonovDecoupled().fit(a, b).predict([0.1, 2.0])
        np.testing.assert_allclose(xtd, xd, atol=1e-7)

    @pytest.mark.parametrize("order", [2, 4, 6])
    def test_xdot_uniform_exact_for_polynomials(self, order):
        t = np.linspace(0, 1, 21)
        dt = t[1] - t[0]
        x = jnp.asarray(t ** order)  # derivative order exact for poly deg<=o
        dx = xdot_uniform(x, dt, order=order)
        expect = order * t ** (order - 1)
        np.testing.assert_allclose(dx, expect, atol=1e-6)

    def test_xdot_nonuniform(self):
        t = np.sort(np.random.default_rng(10).uniform(0, 1, 15))
        x = jnp.asarray(3 * t + 2)
        dx = xdot_nonuniform(x, jnp.asarray(t))
        np.testing.assert_allclose(dx, 3.0, atol=1e-8)


class TestOptim:
    def test_admm_lasso_sparse_recovery(self):
        rng = np.random.default_rng(11)
        n, p = 40, 20
        a = rng.standard_normal((n, p))
        x_true = np.zeros(p)
        x_true[[2, 7, 11]] = [1.5, -2.0, 1.0]
        b = a @ x_true + 0.01 * rng.standard_normal(n)
        res = admm_lasso(jnp.asarray(a), jnp.asarray(b), lam=0.5, rho=1.0,
                         alpha=1.5, n_iters=300)
        z = np.asarray(res.z)
        big = np.abs(z) > 0.2
        assert set(np.nonzero(big)[0]) == {2, 7, 11}
        assert res.objective[-1] < res.objective[0]

    def test_chambolle_pock_tv_denoises(self):
        rng = np.random.default_rng(12)
        clean = np.zeros((32, 32))
        clean[8:24, 8:24] = 1.0
        noisy = clean + 0.2 * rng.standard_normal(clean.shape)
        res = chambolle_pock_tv(jnp.asarray(noisy), lam=0.2, n_iters=200)
        out = np.asarray(res.image)
        assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean()
        assert res.gap[-1] < res.gap[0]


class TestMarching:
    def test_sphere_surface(self):
        g = create_grid([-2, -2, -2], [2, 2, 2], 41)
        phi = np.asarray(sphere(g, radius=1.0, dtype=jnp.float64))
        verts, faces = implicit_mesh(g, phi)
        assert len(verts) > 100 and len(faces) > 100
        r = np.linalg.norm(verts, axis=1)
        assert np.abs(r - 1.0).max() < 0.01  # vertices on the level set
        # faces index valid vertices
        assert faces.max() < len(verts) and faces.min() >= 0

    def test_watertight_euler_characteristic(self):
        """A closed surface of genus 0 has V - E + F = 2."""
        g = create_grid([-2, -2, -2], [2, 2, 2], 33)
        phi = np.asarray(sphere(g, radius=1.2, dtype=jnp.float64))
        verts, faces = implicit_mesh(g, phi)
        edges = set()
        for f in faces:
            for a, b in ((f[0], f[1]), (f[1], f[2]), (f[0], f[2])):
                edges.add((min(a, b), max(a, b)))
        euler = len(verts) - len(edges) + len(faces)
        assert euler == 2, euler

    def test_empty_when_no_crossing(self):
        phi = np.ones((8, 8, 8))
        verts, faces = marching_tetrahedra(phi)
        assert len(verts) == 0 and len(faces) == 0

    def test_native_extractor_matches_numpy(self):
        """The C++ extractor implements the same decomposition as the numpy
        oracle: identical vertex/face counts, watertight, on-level."""
        from levelsetpy_tpu.viz._native import (build,
                                                marching_tetrahedra_native,
                                                native_available)

        assert build(), "building native/marching_tet.cpp failed"
        assert native_available()
        g = create_grid([-2, -2, -2], [2, 2, 2], 33)
        phi = np.asarray(sphere(g, radius=1.1, dtype=jnp.float64))
        sp, og = np.asarray(g.dx), np.asarray(g.lo)
        v1, f1 = marching_tetrahedra(phi, 0.0, sp, og)
        v2, f2 = marching_tetrahedra_native(phi, 0.0, sp, og)
        assert len(v1) == len(v2) and len(f1) == len(f2)
        r = np.linalg.norm(v2, axis=1)
        assert np.abs(r - 1.1).max() < 0.02
        # watertight: every edge shared by exactly two faces
        from collections import Counter

        cnt = Counter()
        for f in f2:
            for a, b in ((f[0], f[1]), (f[1], f[2]), (f[0], f[2])):
                cnt[(min(a, b), max(a, b))] += 1
        assert set(cnt.values()) == {2}

    def test_contour_segments_circle(self):
        g = create_grid([-2, -2], [2, 2], 81)
        phi = np.asarray(sphere(g, radius=1.0, dtype=jnp.float64))
        segs = contour_segments(phi, spacing=np.asarray(g.dx),
                                origin=np.asarray(g.lo))
        assert len(segs) > 20
        r = np.linalg.norm(segs.reshape(-1, 2), axis=1)
        assert np.abs(r - 1.0).max() < 0.05
        # total length approximates the circle circumference
        lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1)
        assert abs(lengths.sum() - 2 * np.pi) < 0.3


class TestIsosurface:
    def test_plane_height_recovered(self):
        """phi = z - h(x, y) has its zero level exactly at z = h."""
        import numpy as np
        from levelsetpy_tpu.viz import isosurface

        x = np.linspace(-1, 1, 21)
        y = np.linspace(-1, 1, 19)
        z = np.linspace(-2, 2, 41)
        h = 0.3 + 0.2 * x[:, None] - 0.1 * y[None, :]
        phi = z[None, None, :] - h[..., None]
        zh = isosurface(phi, 0.0, z)
        assert zh.shape == (21, 19)
        np.testing.assert_allclose(zh, h, atol=0.06)

    def test_axis_argument(self):
        import numpy as np
        from levelsetpy_tpu.viz import isosurface

        z = np.linspace(0.0, 1.0, 31)
        phi = z[:, None] - 0.5 + 0.0 * np.zeros((31, 7))
        zh = isosurface(phi, 0.0, z, axis=0)
        np.testing.assert_allclose(zh, 0.5, atol=0.02)

    def test_exact_hit_no_nan(self):
        import numpy as np
        from levelsetpy_tpu.viz import isosurface

        z = np.linspace(-1.0, 1.0, 21)  # contains exactly 0.0
        phi = np.broadcast_to(z, (4, 21))
        zh = isosurface(phi, 0.0, z)
        assert np.all(np.isfinite(zh))
        # interp_order=6 takes an odd extra neighbor on one side of the tie,
        # so the estimate carries a tiny O(dz/100) bias — same as the ref
        np.testing.assert_allclose(zh, 0.0, atol=2e-3)
