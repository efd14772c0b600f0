"""The control, the plain reference put in the program's place one
precision below the configuration's, comes out not correct against the
cell's limits: float8 products under bfloat16 autocast for the served bf16
graphs, bfloat16 autocast for the float32 train step. On the CPU here, at
small batches (the train step also at small crops);
``perfbench/calibrate.py`` reads it on the chip at the cells' own sizes."""

import pytest

from perfbench import calibrate

from conftest import small_run


@pytest.mark.parametrize("name", ["litehandnet.serve_b128",
                                  "resnet50.serve_b128",
                                  "litehandnet.serve_b1"])
def test_serve_control_fails_the_limits(name, tmp_path):
    # the cells' own 256 x 256 crops, 16 of them: the keypoint distances the
    # limits hold are in image px, which a smaller crop shrinks
    r = small_run(name, tmp_path, mix={"batch": 2, "distinct": 8}, config={})
    got = calibrate.serve_readings(r, "control")
    limits = r.cell.limits
    compared = [n for n, v in limits.items() if isinstance(v, dict)]
    assert any(got[n] > limits[n]["limit"] for n in compared)


def test_train_control_fails_the_limits(tmp_path):
    r = small_run("litehandnet.train_b32", tmp_path)
    got = calibrate.train_readings(r, "bf16")
    limits = r.cell.limits
    compared = [n for n, v in limits.items() if isinstance(v, dict)]
    assert any(got[n] > limits[n]["limit"] for n in compared)
