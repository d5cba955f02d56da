"""A run of each cell at a size the CPU holds, skipping only the look for a
chip: sound, `correct` is true; with the timed path broken underneath, it
comes out false -- once for each fault the cell can have."""

import torch

import pytest

from perfbench.tests import pb_helpers as h


def test_sound_serving_runs_are_correct():
    for name in ("nyu_serve_mixed", "nyu_eval_b128"):
        line = h.run_line(h.tiny(name))
        assert line["correct"], line["checks"]
        assert line["failed"] == 0 and line["attempted"] > 0


def test_sound_training_run_is_correct():
    line = h.run_line(h.tiny("nyu_train_b8"))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["nyu_serve_mixed", "nyu_eval_b128"])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    from cspn_tpu_torch import serving

    run_bucket = serving.DepthServer._run_bucket

    def altered(self, x, bucket):  # the answer mirrored where the bucket produces it
        return torch.flip(run_bucket(self, x, bucket), [-1])

    monkeypatch.setattr(serving.DepthServer, "_run_bucket", altered)
    line = h.run_line(h.tiny(name))
    assert not line["correct"]


def _patch_step(monkeypatch, wrap):
    from cspn_tpu_torch.train import loop

    make = loop.make_train_step
    monkeypatch.setattr(loop, "make_train_step",
                        lambda model, opt, *a, **k: wrap(make(model, opt, *a, **k), model))


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    def wrap(step, model):
        def unchanged(rgbd, depth):
            with torch.no_grad():
                out = model(rgbd)
                return ((out - depth).abs() * (depth > 1e-4)).sum() / (depth > 1e-4).sum(), {}
        return unchanged

    _patch_step(monkeypatch, wrap)
    line = h.run_line(h.tiny("nyu_train_b8"))
    assert not line["correct"]


def test_a_step_on_half_the_batch_is_not_correct(monkeypatch):
    def wrap(step, model):
        return lambda rgbd, depth: step(rgbd[: len(rgbd) // 2], depth[: len(depth) // 2])

    _patch_step(monkeypatch, wrap)
    line = h.run_line(h.tiny("nyu_train_b8"))
    assert not line["correct"]
