"""The port's config package against ``litehandnet_tpu.config``: every
experiment name, ``pcfg``, the ``pred_bbox`` rule, config files and their
file-ID check."""

import pathlib

import pytest

from litehandnet_tpu.config import config_from_dict as jax_config_from_dict
from litehandnet_tpu.config import get_config as jax_get_config
from litehandnet_tpu.config import pcfg as jax_pcfg
from litehandnet_tpu.config.templates import make_cfg as jax_make_cfg
from litehandnet_tpu_torch.config import (
    config_from_dict,
    experiment_names,
    get_config,
    pcfg,
)
from litehandnet_tpu_torch.config.templates import make_cfg

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "litehandnet_tpu" / "config" / "experiments"
JAX_NAMES = sorted(
    "/".join(p.relative_to(EXPERIMENTS).with_suffix("").parts)
    for p in EXPERIMENTS.rglob("*.py") if p.name != "__init__.py")


def test_table_names_are_the_experiment_files():
    assert experiment_names() == JAX_NAMES
    assert len(JAX_NAMES) == 166


@pytest.mark.parametrize("name", JAX_NAMES)
def test_experiment_config_equals_jax(name):
    got, want = get_config(name).to_dict(), jax_get_config(name).to_dict()
    assert got == want
    # tuples stay tuples, lists stay lists
    assert repr(got) == repr(want)


def test_dotted_and_py_names():
    want = jax_get_config("litehandnet/freihand_256_dark_h4_ca_r4").to_dict()
    for name in ("litehandnet.freihand_256_dark_h4_ca_r4",
                 "litehandnet/freihand_256_dark_h4_ca_r4.py"):
        assert get_config(name).to_dict() == want


def test_pcfg_equals_jax():
    assert pcfg.to_dict() == jax_pcfg.to_dict()
    assert pcfg.dark_kernel == 19


@pytest.mark.parametrize("model", ["srhandnet", "litehandnet"])
def test_pred_bbox_rule(model):
    d = make_cfg(model, "freihand", exp_id=3, image_size=128,
                 **{"MODEL.pred_bbox": True, "PIPELINE.rot_prob": 0.7})
    assert d == jax_make_cfg(model, "freihand", exp_id=3, image_size=128,
                             **{"MODEL.pred_bbox": True,
                                "PIPELINE.rot_prob": 0.7})
    cfg = config_from_dict(d)
    assert cfg.PIPELINE.rot_prob == 0
    assert cfg.to_dict() == jax_config_from_dict(d).to_dict()
    assert d["PIPELINE"]["rot_prob"] == 0.7  # the input is not changed


def test_make_cfg_rejects_bare_unknown_section():
    with pytest.raises(KeyError):
        make_cfg("litehandnet", "freihand", flip_prob=0.2)


_FILE = """
from litehandnet_tpu_torch.config.templates import make_cfg


def _get_cfg():
    return make_cfg("litehandnet", "rhd", exp_id={exp_id}, image_size=128,
                    **{{"MODEL.pred_bbox": True, "TRAIN.batch_per_gpu": 4}})
"""


def test_config_file(tmp_path):
    path = tmp_path / "_7_rhd_128.py"
    path.write_text(_FILE.format(exp_id=7))
    cfg = get_config(str(path))
    want = jax_config_from_dict(jax_make_cfg(
        "litehandnet", "rhd", exp_id=7, image_size=128,
        **{"MODEL.pred_bbox": True, "TRAIN.batch_per_gpu": 4}))
    assert cfg.to_dict() == want.to_dict()
    assert cfg.PIPELINE.rot_prob == 0


def test_config_file_id_check(tmp_path):
    path = tmp_path / "_8_rhd_128.py"
    path.write_text(_FILE.format(exp_id=7))
    with pytest.raises(ValueError, match="file id 8"):
        get_config(str(path))


def test_config_file_without_get_cfg(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text("X = 1\n")
    with pytest.raises(ValueError, match="_get_cfg"):
        get_config(str(path))


def test_unknown_name():
    with pytest.raises(KeyError):
        get_config("litehandnet/unknown")
