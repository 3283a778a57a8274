"""Port parity for the stereo-triangulated path, against the JAX package on
identical inputs.

Rigs come from config/calibration.yaml at two scales: the 180x320 fixture of
tests/test_stereo_pipeline.py and bench.py's 64x64 serve chain. Points are
seeded numpy draws at about 1 m in front of the rig, projected into both
views, clean or with 0.3 px Gaussian noise.

Tolerances: linalg 1e-6; projections 1e-4 px; F rtol 1e-6 (the JAX package
rounds the epipole to float32, the port keeps float64); epipolar distances
1e-4 px; greedy matches equal; s'(t), s''(t) against ``jax.grad`` rtol 1e-4,
atol 1e-6; corrected points 1e-3 px; triangulated points 1e-4 m (JAX float32
against float64 differs by up to ~3.3e-5 m on such points). The DLT's
``eigh`` method is held to 1e-4 m in float64 in both packages: float32
eigenvectors of the 4x4 normal matrix are good to only ~2e-4 m at 1 m, in
the JAX package as in the port. The stereo decode: masks equal, 2D within
1e-4 px, 3D within 1e-4 m within 3 m of the camera and 1e-4 m x (|p| / 1 m)^3
from there on (``object_keypoints_tpu_torch.testing.compare_stereo``). The float32
decode against the float64 lift of its own pixels: 3D within
1e-4 m x max(1, (|p| / 1 m)^3), the bound chip_smoke.py holds the card to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.geometry import cameras as jcam  # noqa: E402
from object_keypoints_tpu.geometry import linalg as jlinalg  # noqa: E402
from object_keypoints_tpu.geometry import stereo as jstereo  # noqa: E402
from object_keypoints_tpu.ops import associate as jassoc  # noqa: E402
from object_keypoints_tpu.pipeline import stereo_jit as jpipe  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu_torch.geometry import cameras as cam  # noqa: E402
from object_keypoints_tpu_torch.geometry import linalg  # noqa: E402
from object_keypoints_tpu_torch.geometry import stereo  # noqa: E402
from object_keypoints_tpu_torch.ops import associate as assoc  # noqa: E402
from object_keypoints_tpu_torch.pipeline import stereo as pipe  # noqa: E402
from object_keypoints_tpu_torch.serving import export  # noqa: E402
from object_keypoints_tpu_torch.testing import (  # noqa: E402
    SCENE_KEYPOINTS,
    bench_camera,
    compare_stereo,
    lift_exact,
    serve_rig,
    stereo_3d_tolerance,
    stereo_scene,
)
from test_stereo_pipeline import KEYPOINTS, _heatmaps  # noqa: E402
from test_torch_port_serve import artifact  # noqa: E402,F401

torch.set_num_threads(1)

SCALES = ["fixture", "bench64"]


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def j(a):
    return jnp.asarray(a, jnp.float32)


def close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def make_rig(module, calibration_file, scale):
    """StereoCamera of ``module`` at the fixture scale or bench.py's chain."""
    p = module.load_calibration_params(calibration_file)
    views = []
    for K, D in ((p["K"], p["D"]), (p["Kp"], p["Dp"])):
        camera = module.FisheyeCamera(K, D, p["image_size"])
        views.append(camera.scale(180.0 / 720.0) if scale == "fixture" else bench_camera(camera))
    return module.StereoCamera(*views, p["T_RL"])


@pytest.fixture(scope="module", params=SCALES)
def rigs(request, calibration_file):
    return (make_rig(cam, calibration_file, request.param),
            make_rig(jcam, calibration_file, request.param))


def correspondences(rig, n=256, noise=0.0, seed=0, pinhole=False):
    """n points at x, y within +-0.3 m, z in [0.8, 1.2] m, projected into both
    views (float64; through the fisheye model, or the undistorted pinhole
    projection) plus Gaussian pixel noise."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n),
                  rng.uniform(0.8, 1.2, n)], axis=-1)
    X_R = X @ rig.T_RL[:3, :3].T + rig.T_RL[:3, 3]
    if pinhole:
        p_l = (X @ rig.left_camera.K.T)[:, :2] / X[:, 2:]
        p_r = (X_R @ rig.right_camera.K.T)[:, :2] / X_R[:, 2:]
    else:
        p_l, p_r = rig.left_camera.project(X), rig.right_camera.project(X_R)
    return X, p_l + rng.normal(0, noise, p_l.shape), p_r + rng.normal(0, noise, p_r.shape)


def rig_args(rig):
    return (rig.left_camera.K, rig.left_camera.D, rig.right_camera.K, rig.right_camera.D,
            rig.T_RL, rig.F)


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


# ---------------------------------------------------------------------------
# geometry: linalg and cameras
# ---------------------------------------------------------------------------


def test_linalg_matches():
    rng = np.random.default_rng(1)
    R1, R2 = random_rotations(rng, 8).astype(np.float32), random_rotations(rng, 8).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    T[:, :3, :3] = R1
    T[:, :3, 3] = rng.normal(size=(8, 3))
    v = rng.normal(size=(8, 3)).astype(np.float32)
    close(linalg.skew_matrix(t(v)), jlinalg.skew_matrix(v), 0, "skew")
    close(linalg.skew_matrix(t(v)) @ t(v)[..., None], np.zeros((8, 3, 1)), 1e-6, "skew v x v")
    close(linalg.inv_transform(t(T)), jlinalg.inv_transform(T), 1e-6, "inv_transform")
    close(linalg.transform_points(t(T[0]), t(v)), jlinalg.transform_points(T[0], v), 1e-6,
          "transform_points")
    close(linalg.rotation_matrix_to_euler_xyz(t(R1)), jlinalg.rotation_matrix_to_euler_xyz(R1),
          1e-6, "euler")
    close(linalg.angle_between(t(R1), t(R2)), jlinalg.angle_between(R1, R2), 1e-6, "angle_between")
    close(linalg.rotation_angle(t(R1), t(R2)), jlinalg.rotation_angle(R1, R2), 1e-6,
          "rotation_angle")
    # numpy float64 in -> float64 out
    assert linalg.inv_transform(T[0].astype(np.float64)).dtype == torch.float64


def test_projections_match(calibration_file):
    rng = np.random.default_rng(2)
    p = cam.load_calibration_params(calibration_file)
    K, D = p["K"].astype(np.float32), p["D"].astype(np.float32)
    D_rt = np.array([-0.28, 0.07, 1e-4, -2e-4], np.float32)
    X = np.stack([rng.uniform(-0.4, 0.4, 200), rng.uniform(-0.3, 0.3, 200),
                  rng.uniform(0.5, 2.0, 200)], -1).astype(np.float32)
    T_CW = p["T_RL"].astype(np.float32)
    xy = X[:, :2] / X[:, 2:]
    close(cam.radtan_distort_normalized(t(xy), t(D_rt)),
          jcam.radtan_distort_normalized(xy, D_rt), 1e-6, "radtan distort")
    close(cam.radtan_project(t(X), t(K), t(D_rt)), jcam.radtan_project(X, K, D_rt), 1e-4,
          "radtan project")
    for model, dist in (("equidistant", D), ("radtan", D_rt)):
        close(cam.project_points(t(X), t(T_CW), t(K), t(dist), model),
              jcam.project_points(X, T_CW, K, dist, model), 1e-4, model)
    with pytest.raises(ValueError):
        cam.project_points(t(X), t(T_CW), t(K), t(D), "pinhole")
    # radtan undistort inverts radtan projection
    uv = cam.radtan_project(t(X).double(), t(K).double(), t(D_rt).double())
    und = cam.radtan_undistort_points(uv, t(K).double(), t(D_rt).double(), P=t(K).double())
    xy64 = t(X, torch.float64)[:, :2] / t(X, torch.float64)[:, 2:]
    close(und, cam.apply_K(xy64, t(K).double()), 1e-6, "radtan round trip")


def test_host_cameras_match(calibration_file, tmp_path):
    """The host classes (float64 here, float32 in the JAX package)."""
    rng = np.random.default_rng(3)
    p = cam.load_calibration_params(calibration_file)
    D_rt = np.array([-0.28, 0.07, 1e-4, -2e-4])
    X = np.stack([rng.uniform(-0.4, 0.4, 50), rng.uniform(-0.3, 0.3, 50),
                  rng.uniform(0.5, 2.0, 50)], -1)
    for cls, jcls, D in ((cam.FisheyeCamera, jcam.FisheyeCamera, p["D"]),
                         (cam.RadTanPinholeCamera, jcam.RadTanPinholeCamera, D_rt)):
        mine, ref = cls(p["K"], D, p["image_size"]), jcls(p["K"], D, p["image_size"])
        uv = mine.project(X)
        assert uv.dtype == np.float64
        close(uv, ref.project(X), 1e-3, f"{cls.__name__}.project")
        close(mine.project(X, p["T_RL"]), ref.project(X, p["T_RL"]), 1e-3, "project T_CW")
        und = mine.undistort(uv)
        close(und, ref.undistort(uv), 1e-3, f"{cls.__name__}.undistort")
        close(mine.unproject(und, X[:, 2]), ref.unproject(und, X[:, 2]), 1e-5, "unproject")
        close(mine.unproject(und, X[:, 2]), X, 1e-6, "project -> undistort -> unproject")
        pts = np.array([[-1.0, 5.0], [5.0, 5.0], [1279.5, 719.5], [1280.0, 3.0]])
        equal(mine.in_frame(pts), ref.in_frame(pts), "in_frame")
        # the reference quirk: scale and cut give a FisheyeCamera
        assert type(mine.scale(0.5)) is cam.FisheyeCamera
        assert type(mine.cut(np.array([10.0, 0.0]))) is cam.FisheyeCamera
    close(cam.projection_matrix(p["K"], p["T_RL"]), jcam.projection_matrix(p["K"], p["T_RL"]),
          0, "projection_matrix")
    got, want = cam.from_calibration(calibration_file), jcam.from_calibration(calibration_file)
    assert type(got) is cam.FisheyeCamera
    close(got.K, want.K, 0, "from_calibration K")
    close(got.image_size, want.image_size, 0, "from_calibration size")
    radtan = tmp_path / "radtan.yaml"
    radtan.write_text(open(calibration_file).read().replace("equidistant", "radtan", 1))
    assert type(cam.from_calibration(str(radtan))) is cam.RadTanPinholeCamera


def test_stereo_camera_matches(calibration_file, rigs):
    mine, ref = rigs
    close(mine.F, ref.F, 0, "F", rtol=1e-6)
    close(mine.T_LR, ref.T_LR, 1e-6, "T_LR")  # float32 in the JAX package
    close(mine.T_LR, cam.load_calibration_params(calibration_file)["T_LR"], 1e-12, "T_LR file")
    full = cam.StereoCamera.from_file(calibration_file)
    close(full.F, jcam.StereoCamera.from_file(calibration_file).F, 0, "from_file F", rtol=1e-6)
    # x_r^T F x_l = 0 on exact pinhole correspondences
    _, p_l, p_r = correspondences(mine, pinhole=True)
    h_l, h_r = np.pad(p_l, ((0, 0), (0, 1)), constant_values=1), np.pad(p_r, ((0, 0), (0, 1)),
                                                                       constant_values=1)
    assert np.abs(np.einsum("ni,ij,nj->n", h_r, mine.F, h_l)).max() < 1e-9


# ---------------------------------------------------------------------------
# epipolar matching
# ---------------------------------------------------------------------------


def test_epipolar_distances(rigs):
    mine, ref = rigs
    _, p_l, p_r = correspondences(mine, n=2 * 3 * 12, noise=0.5, seed=4)
    p_l = p_l.reshape(2, 3, 12, 2).astype(np.float32)
    p_r = p_r.reshape(2, 3, 12, 2)[:, :, :10].astype(np.float32)
    got = stereo.epipolar_distances(t(mine.F), t(p_l), t(p_r))
    want = jax.vmap(jax.vmap(lambda a, b: jstereo.epipolar_distances(j(ref.F), a, b)))(
        j(p_l), j(p_r))
    assert got.shape == (2, 3, 12, 10)
    close(got, want, 1e-4, "epipolar distances")
    # a true correspondence lies on its epipolar line
    assert (torch.diagonal(got, dim1=-2, dim2=-1) < 2.5).all()


@pytest.mark.parametrize("threshold", [1.0, 2.0, 3.5])
def test_greedy_epipolar_match(threshold):
    """Integer distances make ties common; rows and columns of invalid
    points, and whole cells with no valid point, must never match."""
    rng = np.random.default_rng(int(threshold * 10))
    B, L, R = 24, 8, 6
    d = rng.integers(0, 6, size=(B, L, R)).astype(np.float32)
    left_valid = rng.uniform(size=(B, L)) > 0.25
    right_valid = rng.uniform(size=(B, R)) > 0.25
    left_valid[0] = False
    right_valid[1] = False
    d[2] = 1.0  # one tie across the whole matrix
    for max_matches in (None, 3, L):
        got = assoc.greedy_epipolar_match(t(d), t(left_valid, torch.bool),
                                          t(right_valid, torch.bool), threshold, max_matches)
        want = jax.vmap(lambda a, lv, rv: jassoc.greedy_epipolar_match(
            a, lv, rv, threshold=threshold, max_matches=max_matches))(
                j(d), jnp.asarray(left_valid), jnp.asarray(right_valid))
        assert got.dtype == torch.int32 and got.shape == (B, L)
        equal(got, want, f"assignment max_matches={max_matches}")
        assert (got[0] == -1).all() and (got[1] == -1).all()
        for b in range(B):  # mutually exclusive
            matched = got[b][got[b] >= 0]
            assert matched.unique().numel() == matched.numel()


def test_greedy_tie_order():
    d = torch.ones(1, 3, 3)
    got = assoc.greedy_epipolar_match(d, torch.ones(1, 3, dtype=torch.bool),
                                      torch.ones(1, 3, dtype=torch.bool), 2.0)
    assert got.tolist() == [[0, 1, 2]]
    d[0, 1, 0] = 0.5  # the strict minimum goes first, then row-major ties
    got = assoc.greedy_epipolar_match(d, torch.ones(1, 3, dtype=torch.bool),
                                      torch.ones(1, 3, dtype=torch.bool), 2.0)
    assert got.tolist() == [[1, 0, 2]]


# ---------------------------------------------------------------------------
# Hartley-Sturm correction and triangulation
# ---------------------------------------------------------------------------


def _jax_cost(t_, f, fp, a, b, c, d):
    """The cost of object_keypoints_tpu/geometry/stereo.py:90-94."""
    num_l = t_ * t_ / (1.0 + f * f * t_ * t_)
    denom = (a * t_ + b) ** 2 + fp * fp * (c * t_ + d) ** 2
    return num_l + (c * t_ + d) ** 2 / denom


def test_cost_derivatives_match_jax_grad():
    rng = np.random.default_rng(5)
    n = 400
    coef = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.normal(0, 1, n),
                     rng.normal(0, 1, n), rng.normal(0, 1, n), rng.normal(0, 1, n)]).astype(np.float32)
    ts = np.concatenate([rng.uniform(-3, 3, n - 40), rng.uniform(-100, 100, 40)]).astype(np.float32)
    ds = jax.vmap(jax.grad(_jax_cost))
    d2s = jax.vmap(jax.grad(jax.grad(_jax_cost)))
    g, h = stereo.cost_derivatives(t(ts), *t(coef))
    close(g, ds(j(ts), *j(coef)), 1e-6, "s'(t)", rtol=1e-4)
    close(h, d2s(j(ts), *j(coef)), 1e-6, "s''(t)", rtol=1e-4)
    # and the cost itself
    close(stereo._cost(t(ts), *t(coef)), _jax_cost(j(ts), *j(coef)), 1e-6, "s(t)", rtol=1e-5)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_correct_matches(rigs, noise):
    mine, ref = rigs
    _, p_l, p_r = correspondences(mine, noise=noise, seed=6, pinhole=True)
    got_l, got_r = stereo.correct_matches(t(mine.F), t(p_l), t(p_r))
    want_l, want_r = jstereo.correct_matches(j(ref.F), j(p_l), j(p_r))
    close(got_l, want_l, 1e-3, "corrected left")
    close(got_r, want_r, 1e-3, "corrected right")
    # corrected pairs satisfy the epipolar constraint; clean ones barely move
    x_l = torch.cat([got_l.double(), torch.ones(len(p_l), 1, dtype=torch.float64)], -1)
    x_r = torch.cat([got_r.double(), torch.ones(len(p_r), 1, dtype=torch.float64)], -1)
    assert torch.einsum("ni,ij,nj->n", x_r, t(mine.F, torch.float64), x_l).abs().max() < 1e-3
    if noise == 0.0:
        close(got_l, p_l, 1e-3, "clean left moved")
    # batched leading dimensions give the same answer
    batched = stereo.correct_matches(t(mine.F), t(p_l).reshape(4, -1, 2), t(p_r).reshape(4, -1, 2))
    equal(batched[0].reshape(-1, 2), got_l, "batched")


def test_triangulate_linear(rigs):
    mine, ref = rigs
    _, p_l, p_r = correspondences(mine, noise=0.3, seed=7, pinhole=True)
    P1 = cam.projection_matrix(mine.left_camera.K, np.eye(4))
    P2 = cam.projection_matrix(mine.right_camera.K, mine.T_RL)
    got = stereo.triangulate_linear(t(P1), t(P2), t(p_l), t(p_r))
    close(got, jstereo.triangulate_linear(j(P1), j(P2), j(p_l), j(p_r)), 1e-4, "solve")
    f64 = [t(a, torch.float64) for a in (P1, P2, p_l, p_r)]
    with jax.enable_x64(True):
        want = jstereo.triangulate_linear(*(jnp.asarray(a, jnp.float64) for a in (P1, P2, p_l, p_r)),
                                          method="eigh")
        close(stereo.triangulate_linear(*f64, method="eigh"), want, 1e-4, "eigh float64")
        want_solve = jstereo.triangulate_linear(*(jnp.asarray(a, jnp.float64)
                                                  for a in (P1, P2, p_l, p_r)))
        close(stereo.triangulate_linear(*f64), want_solve, 1e-9, "solve float64")
    # float32 eigh against its own float64 answer, at float32 eigenvector accuracy
    close(stereo.triangulate_linear(t(P1), t(P2), t(p_l), t(p_r), method="eigh"),
          stereo.triangulate_linear(*f64, method="eigh"), 1e-3, "eigh float32")
    with pytest.raises(ValueError):
        stereo.triangulate_linear(t(P1), t(P2), t(p_l), t(p_r), method="svd")


@pytest.mark.parametrize("correct", [True, False])
def test_triangulate_pixels(rigs, correct):
    mine, ref = rigs
    X, p_l, p_r = correspondences(mine, noise=0.3, seed=8)
    got = stereo.triangulate_pixels(t(p_l), t(p_r), *(t(a) for a in rig_args(mine)),
                                    correct=correct)
    want = jstereo.triangulate_pixels(j(p_l), j(p_r), *(j(a) for a in rig_args(ref)),
                                      correct=correct)
    close(got, want, 1e-4, f"triangulate_pixels correct={correct}")
    if correct:  # the host class, float64 here and float32 in the JAX package
        close(mine.triangulate(p_l, p_r), ref.triangulate(p_l, p_r), 1e-4, "StereoCamera")
        _, c_l, c_r = correspondences(mine, seed=8)
        close(mine.triangulate(c_l, c_r), X, 1e-6, "clean round trip")


# ---------------------------------------------------------------------------
# the stereo slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_rigs(calibration_file):
    return make_rig(cam, calibration_file, "fixture"), make_rig(jcam, calibration_file, "fixture")


NEAR = 3.0  # m: 3D is held to a flat 1e-4 m this close to the camera


def compare_decoded(got, want, what):
    """Masks equal, 2D within 1e-4 px, 3D within 1e-4 m within NEAR and
    the float32 bound 1e-4 m x (|p| / 1 m)^3 beyond: random weights match
    peaks at near-zero disparity, where float32 rounding moves a point by
    metres."""
    return compare_stereo(got, want, what, atol_2d=1e-4, flat_to=NEAR)


def test_stereo_decode_analytic_matches_jax(fixture_rigs):
    mine, ref = fixture_rigs
    heat_l, heat_r, *_ = _heatmaps(ref, KEYPOINTS)
    kw = dict(max_peaks=8, peak_threshold=0.5, epipolar_threshold=3.0)
    want = jpipe.stereo_decode_triangulate(j(heat_l), j(heat_r),
                                           jpipe.StereoRigArrays.from_stereo_camera(ref), **kw)
    got = pipe.stereo_decode_triangulate(t(heat_l), t(heat_r),
                                         pipe.StereoRigArrays.from_stereo_camera(mine), **kw)
    compare_decoded(got, want, "one pair")
    assert got.match_valid.sum(-1).tolist() == [1, 1, 3]
    # a batch of pairs, with one view flipped so the pairs differ
    pairs_l, pairs_r = np.stack([heat_l, heat_l]), np.stack([heat_r, heat_r[:, :, ::-1]])
    want_b = jax.vmap(lambda a, b: jpipe.stereo_decode_triangulate(
        a, b, jpipe.StereoRigArrays.from_stereo_camera(ref), **kw))(j(pairs_l), j(pairs_r))
    got_b = pipe.stereo_decode_triangulate(t(pairs_l), t(pairs_r),
                                           pipe.StereoRigArrays.from_stereo_camera(mine), **kw)
    compare_decoded(got_b, want_b, "batch")


def test_stereo_decode_fixture_gate(fixture_rigs, calibration_file):
    """The port alone: numpy Gaussians at the port's projections of the
    fixture keypoints, decoded and triangulated within the 5 cm gate."""
    rig, heat_l, heat_r, points, channels = stereo_scene(calibration_file)
    np.testing.assert_array_equal(SCENE_KEYPOINTS, KEYPOINTS)
    close(rig.F, fixture_rigs[0].F, 0, "the scene's rig is the fixture rig")
    out = pipe.stereo_decode_triangulate(t(heat_l), t(heat_r),
                                         pipe.StereoRigArrays.from_stereo_camera(rig),
                                         max_peaks=8, epipolar_threshold=3.0)
    assert out.match_valid.sum(-1).tolist() == [1, 1, 3]
    for c, idx in enumerate(channels):
        for p in out.points_3d[c][out.match_valid[c]].numpy():
            assert np.linalg.norm(points[idx] - p, axis=1).min() < 5e-2
    assert (out.points_3d[~out.match_valid] == 0).all()


def test_stereo_slice_tiny_artifact(artifact, calibration_file):
    """frames -> forward -> stereo decode through both packages: the maps
    agree to atol 1e-4; the decode of the same maps to the tolerances above."""
    frames = np.random.default_rng(23).normal(size=(4, 3, 128, 128)).astype(np.float32)
    jheat, *_ = jexport.load_inference_fn(artifact, quantize="never")(jnp.asarray(frames))
    heat, *_ = export.load_inference_fn(artifact, device="cpu")(frames)
    close(heat, jheat, 1e-4, "heatmaps")
    rigs = []
    for module in (cam, jcam):
        p = module.load_calibration_params(calibration_file)
        rigs.append(module.StereoCamera(*(
            bench_camera(module.FisheyeCamera(K, D, p["image_size"]), 16)
            for K, D in ((p["K"], p["D"]), (p["Kp"], p["Dp"]))), p["T_RL"]))
    kw = dict(max_peaks=8, peak_threshold=0.5, epipolar_threshold=3.0)
    jheat = np.asarray(jheat)
    want = jax.vmap(lambda a, b: jpipe.stereo_decode_triangulate(
        a, b, jpipe.StereoRigArrays.from_stereo_camera(rigs[1]), **kw))(j(jheat[:2]), j(jheat[2:]))
    got = pipe.stereo_decode_triangulate(t(jheat[:2]), t(jheat[2:]),
                                         pipe.StereoRigArrays.from_stereo_camera(rigs[0]), **kw)
    compare_decoded(got, want, "tiny artifact")
    # random weights still give matches, near ones among them
    near = got.match_valid & (got.points_3d.norm(dim=-1) < NEAR)
    assert near.sum() >= 5, near.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_decode_float32_within_bound_of_float64_lift(calibration_file, seed):
    """The float32 decode of random maps through bench.py's chain (dense
    matches, many at near-zero disparity) against the float64 lift of its
    own matched pixels, the bound chip_smoke.py holds the card to; and the
    bound's premise, that the rounding is the DLT's and not the
    correction's: the float32 correction differs from the float64 one by
    under 1e-4 px."""
    rig = serve_rig(cam.load_calibration_params(calibration_file))
    g = torch.Generator().manual_seed(seed)
    left, right = torch.rand(16, 3, 64, 64, generator=g), torch.rand(16, 3, 64, 64, generator=g)
    out = pipe.stereo_decode_triangulate(left, right, pipe.StereoRigArrays.from_stereo_camera(rig),
                                         max_peaks=16, peak_threshold=0.5, epipolar_threshold=3.0)
    rig64 = pipe.StereoRigArrays.from_stereo_camera(rig, dtype=torch.float64)
    exact = lift_exact(out, rig64)
    worst, held, no_depth = compare_stereo(out, exact, "float32 vs float64", atol_2d=0.0)
    assert held > 400 and no_depth < held // 100, (held, no_depth)
    dist = exact.points_3d[out.match_valid].norm(dim=-1)
    assert (dist > 3.0).sum() > 10  # the far matches are held too
    assert stereo_3d_tolerance(np.array([[0.0, 0.0, 2.0]]))[0] == pytest.approx(8e-4)

    pl, pr = out.points_left[out.match_valid], out.points_right[out.match_valid]
    und = [cam.fisheye_undistort_points(p.double(), K, D, P=K)
           for p, K, D in ((pl, rig64.K, rig64.D), (pr, rig64.Kp, rig64.Dp))]
    c64 = stereo.correct_matches(rig64.F, *und)
    c32 = stereo.correct_matches(rig64.F.float(), *(u.float() for u in und))
    for a, b in zip(c32, c64):
        close(a.double(), b, 1e-4, "float32 correction")
