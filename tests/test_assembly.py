"""Normal-equation assembly modes and the backend solver choices
(ops/schur_ba.py assemble, default_assembly, default_refine_method)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from slslam.config import CameraConfig
from slslam.ops.schur_ba import (_eval_pose_system, _eval_system,
                                 _obs_blocks, default_assembly,
                                 default_refine_method)

CAM = CameraConfig()
BL, HD = CAM.baseline, 1.0 / CAM.focal_length


@pytest.fixture(scope="module")
def problem():
    """Camera-major house problem: 5 cameras x 80 rows, 80 line slots,
    padding rows with NaN garbage observations."""
    args = chip_smoke.house_problem(5, 80, 80, jnp.float64)
    valid = np.asarray(args[5])
    assert 0 < valid.sum() < valid.size
    assert np.isnan(np.asarray(args[2])[~valid]).all()
    return args


def _common(problem):
    cam, orth, obs, ocam, olin, valid, cam_free, line_free = problem
    dt = cam.dtype
    return (cam, orth, obs, ocam, olin, valid.astype(dt),
            cam_free.astype(dt), line_free.astype(dt), BL, HD, True)


def _reference(problem):
    common = _common(problem)
    _, *blocks = _obs_blocks(*common)
    C, L = problem[0].shape[0], problem[1].shape[0]
    return chip_smoke.assemble_reference(*blocks, problem[3], problem[4],
                                         C, L)


@pytest.mark.parametrize("system,mode", [
    ("full", "scatter"), ("full", "onehot"), ("full", "blocked"),
    ("pose", "scatter"), ("pose", "onehot")])
def test_assembly_matches_add_at(problem, system, mode):
    ref = _reference(problem)
    common = _common(problem)
    if system == "full":
        got = _eval_system(*common, assembly=mode)[1:]
        want = ref
    else:
        c = common
        got = _eval_pose_system(*c[:7], *c[8:], assembly=mode)[1:]
        want = (ref[0], ref[2])
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())


def test_unknown_assembly_mode_is_refused(problem):
    with pytest.raises(ValueError, match="unknown assembly"):
        _eval_system(*_common(problem), assembly="pallas")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_default_assembly_per_platform(platform):
    # scatter won on both backends (PERF.md, "Assembly and refine method")
    assert default_assembly(platform) == "scatter"
    assert default_assembly(platform) in chip_smoke.ASSEMBLY_MODES


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_unmeasured_platform_is_an_error(platform):
    with pytest.raises(ValueError, match="no measured solver choice"):
        default_assembly(platform)
    with pytest.raises(ValueError, match="no measured solver choice"):
        default_refine_method(platform, 10, 10, False)


def test_default_refine_method():
    small, big_cams, big_map = (100, 80), (200, 80), (128, 4000)
    assert default_refine_method("cpu", *small, False) == "dense"
    # CG won the 100-keyframe refine on the H100 (PERF.md)
    assert default_refine_method("gpu", *small, False) == "cg"
    for platform in ("cpu", "gpu"):
        assert default_refine_method(platform, *small, True) == "cg"
        assert default_refine_method(platform, *big_cams, False) == "cg"
        assert default_refine_method(platform, *big_map, False) == "cg"


def test_engine_default_follows_the_selection_point():
    from slslam.engine.batch import BatchSlam
    backend = jax.default_backend()
    assert BatchSlam().assembly == default_assembly(backend)
    assert BatchSlam(assembly="onehot").assembly == "onehot"


@pytest.mark.gpu
def test_assembly_compiled_on_the_card(gpu_device):
    """Every mode, compiled for the card, against the float64 reference
    at the batch window's shape, in float32 at precision=highest."""
    C, L, O, step = chip_smoke.WINDOW_SHAPE
    with jax.default_device(gpu_device):
        problem = chip_smoke.house_problem(C, L, O // C, jnp.float32, step)
        errs = chip_smoke.assembly_errors(problem, reps=1)
    for mode, e in errs.items():
        assert e["rel_err"] <= 1e-5, (mode, e)
