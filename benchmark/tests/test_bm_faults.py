"""With the timed path broken underneath, a run's ``correct`` comes out
false: the look for a chip skipped, the rest of a run driven at a tiny size
on the CPU, once for each fault a cell can have (one card each, so no
exchange between chips to leave out)."""

import dataclasses

import pytest

from tiny import run_cell


@pytest.fixture
def train_step_module():
    from layoutdetr_tpu_torch.training import train_step

    return train_step


def test_sound_runs_are_correct():
    assert run_cell("r50.train.fp32")["correct"] is True
    assert run_cell("r50.generate.fp32")["correct"] is True


def test_step_that_returns_its_state_unchanged(monkeypatch, train_step_module):
    monkeypatch.setattr(train_step_module, "_apply", lambda opt, params, grads: None)
    line = run_cell("r50.train.fp32")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch, train_step_module):
    real = train_step_module.make_train_step

    def halved(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(state, batch, generator, z=None):
            b = batch["labels"].shape[0] // 2
            return step(state, {k: v[:b] for k, v in batch.items()}, generator, z)

        return run

    monkeypatch.setattr(train_step_module, "make_train_step", halved)
    assert run_cell("r50.train.fp32")["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from layoutdetr_tpu_torch import generate

    real = generate.generate_layouts

    def altered(*args, **kwargs):
        layouts = real(*args, **kwargs)
        first = layouts[0]
        raw = first.raw.copy()
        raw[0, 0] += 1e-3
        return [dataclasses.replace(first, raw=raw)] + layouts[1:]

    monkeypatch.setattr(generate, "generate_layouts", altered)
    line = run_cell("r50.generate.fp32")
    assert line["correct"] is False
    assert line["checks"]["box_gap"]["value"] == pytest.approx(1e-3, rel=1e-3)
