"""chip_smoke.py on CPU: the device guard, the verdict line, and the
phase functions at tiny sizes (the full sizes run on a card)."""

import json

import jax
import numpy as np
import pytest

import chip_smoke


def test_device_guard_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu()


def test_main_on_cpu_fails_without_the_ok_line(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_ok_line_is_exact():
    line = chip_smoke.ok_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_phase_batch_tiny(capsys):
    # 40 frames: raw ATE 0.43 m (the frozen early edges), refined 0.002 m
    out, ctx = chip_smoke.phase_batch(dtype="float64", num_frames=40,
                                      max_ate_raw=0.6,
                                      max_ate_refined=0.005)
    assert out["keyframes"] == 40
    assert out["ate_refined_m"] < out["ate_raw_m"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "batch"


def test_phase_interactive_tiny():
    out = chip_smoke.phase_interactive(frames=30, max_ate=0.1)
    assert out["ate_m"] < 0.1


def test_assembly_errors_tiny():
    import jax.numpy as jnp
    errs = chip_smoke.assembly_errors(
        chip_smoke.house_problem(4, 80, 32, jnp.float32), reps=1)
    assert set(errs) == set(chip_smoke.ASSEMBLY_MODES)
    for e in errs.values():
        assert e["rel_err"] <= 1e-5 and e["eval_s"] > 0


def test_four_card_checks_on_virtual_devices():
    devices = jax.devices()[:4]
    ba = chip_smoke.dist_ba_check(devices, shape=(4, 80, 128, 1),
                                  dtype="float64", cam_tol=1e-9,
                                  line_tol=1e-6, cost_rtol=1e-9)
    assert ba["line_shards_span"]
    pgo = chip_smoke.dist_pgo_check(devices, dtype="float64", tol=1e-8)
    assert pgo["replicated_span"]
    with pytest.raises(chip_smoke.SmokeFailure, match="needs 4 devices"):
        chip_smoke.phase_four_cards(jax.devices()[:2])
