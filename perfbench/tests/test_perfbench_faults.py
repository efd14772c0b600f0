"""A run whose timed path is broken underneath comes out not correct: the
harness runs as on the chip (past its look for one), at the small size on
the CPU, with one fault planted in the program each time. A sound run of
the same size comes out correct."""

import pytest
import torch

from perfbench.core import faults, result

from conftest import small_run


def run_line(name, tmp_path, **kw):
    return result.execute(small_run(name, tmp_path, **kw))


@pytest.mark.parametrize("name", ["litehandnet.serve_b128",
                                  "resnet50.serve_b128",
                                  "litehandnet.serve_b1",
                                  "litehandnet.train_b32"])
def test_sound_run_is_correct(name, tmp_path):
    assert run_line(name, tmp_path)["correct"] is True


SERVE_FAULTS = [("litehandnet.serve_b128", "half_batch"),
                ("litehandnet.serve_b128", "altered_maxval"),
                ("litehandnet.serve_b128", "altered_preds"),
                ("litehandnet.serve_b1", "stale"),
                ("litehandnet.serve_b1", "altered_maxval"),
                ("litehandnet.serve_b1", "altered_preds"),
                ("resnet50.serve_b128", "half_batch"),
                ("resnet50.serve_b128", "altered_maxval"),
                ("resnet50.serve_b128", "altered_preds")]


@pytest.mark.parametrize("name,kind", SERVE_FAULTS)
def test_serve_fault_is_not_correct(name, kind, tmp_path):
    # the cells' own 256 x 256 crops: the keypoint distances the limits hold
    # are in image px, which a smaller crop shrinks
    mix = {"distinct": 4, "batch": 1 if name.endswith("_b1") else 2}
    with faults.planted(kind):
        line = run_line(name, tmp_path, mix=mix, config={})
    assert line["correct"] is False and line["failed"] == line["attempted"]


def test_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    from litehandnet_tpu_torch.train import distributed

    make = distributed.make_train_step

    def frozen(*args, **kw):
        step = make(*args, **kw)

        def train_step(state, batch, generator=None):
            saved = [p.detach().clone() for p in state.model.parameters()]
            metrics = step(state, batch, generator)
            with torch.no_grad():
                for p, old in zip(state.model.parameters(), saved):
                    p.copy_(old)
            return metrics

        return train_step

    monkeypatch.setattr("litehandnet_tpu_torch.train.trainer.make_train_step",
                        frozen)
    line = run_line("litehandnet.train_b32", tmp_path)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def after_checked_steps(change):
    """``make_train_step`` whose steps after the checked ones (from the
    window on) end in ``change(params, saved)``."""
    from litehandnet_tpu_torch.train import distributed

    make = distributed.make_train_step

    def made(*args, **kw):
        step = make(*args, **kw)
        calls = [0]

        def train_step(state, batch, generator=None):
            saved = [p.detach().clone() for p in state.model.parameters()]
            metrics = step(state, batch, generator)
            calls[0] += 1
            if calls[0] > 3:
                with torch.no_grad():
                    change(list(state.model.parameters()), saved)
            return metrics

        return train_step

    return made


def test_step_that_stops_updating_after_the_checked_steps(tmp_path,
                                                         monkeypatch):
    def frozen(params, saved):
        for p, old in zip(params, saved):
            p.copy_(old)

    monkeypatch.setattr("litehandnet_tpu_torch.train.trainer.make_train_step",
                        after_checked_steps(frozen))
    line = run_line("litehandnet.train_b32", tmp_path)
    assert line["correct"] is False
    assert line["checks"]["late_update_gap"]["value"] == pytest.approx(1.0)


def test_update_of_the_wrong_sign_after_the_checked_steps(tmp_path,
                                                          monkeypatch):
    def reversed_(params, saved):
        for p, old in zip(params, saved):
            p.copy_(2 * old - p)

    monkeypatch.setattr("litehandnet_tpu_torch.train.trainer.make_train_step",
                        after_checked_steps(reversed_))
    line = run_line("litehandnet.train_b32", tmp_path)
    assert line["correct"] is False
    # the second late step starts where the reversed first one left it
    assert line["checks"]["late_update_gap"]["value"] == pytest.approx(
        2.0, abs=0.05)


def test_half_of_each_train_batch_left_out(tmp_path, monkeypatch):
    from litehandnet_tpu_torch.train import distributed

    to_device = distributed.batch_to_device

    def half(batch, device):
        out = to_device(batch, device)
        n = out["img"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}

    monkeypatch.setattr(distributed, "batch_to_device", half)
    line = run_line("litehandnet.train_b32", tmp_path, mix={"batch": 4})
    assert line["correct"] is False
