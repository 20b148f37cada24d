"""A run with the timed path broken underneath comes out not correct: each
fault the cells can have, at the tiny presets on the CPU, held to the
cells' own limits (the harness's look for a card skipped)."""

import pytest
import torch

from conftest import tiny_cell
from portbench import harness


def run(cell):
    return harness.run_cell(cell, 2**31 + 21, 0.2, False, "cpu")


@pytest.mark.parametrize("which,preset", [("train", "tiny"), ("train_moe", "tiny_moe"), ("extract", "tiny")])
def test_sound_run_is_correct(which, preset):
    assert run(tiny_cell(which, preset))["correct"] is True


@pytest.mark.parametrize("which,preset", [("train", "tiny"), ("train_moe", "tiny_moe")])
def test_state_left_unchanged(monkeypatch, which, preset):
    from vision_compression_project_tpu_torch.train import train_step

    monkeypatch.setattr(train_step.AdamW, "update", lambda self, params, state, reduce_sq=None: state)
    result = run(tiny_cell(which, preset))
    assert result["correct"] is False
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("which,preset", [("train", "tiny"), ("train_moe", "tiny_moe")])
def test_half_of_the_batch_left_out(monkeypatch, which, preset):
    from vision_compression_project_tpu_torch.train import data

    real = data.device_batch

    def half(*a, **k):
        full = real(*a, **k)
        n = full["token_ids"].shape[0] // 2
        return {key: v[:n] for key, v in full.items()}

    monkeypatch.setattr(data, "device_batch", half)
    assert run(tiny_cell(which, preset))["correct"] is False


def test_token_altered_where_it_is_produced(monkeypatch):
    from vision_compression_project_tpu_torch.models.vlm import VLMRunner

    real = VLMRunner.generate

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        with torch.inference_mode():
            out[:, 1] = torch.where(out[:, 1] == 104, 105, 104)     # 'h' or 'i': allowed, not the greedy token
        return out

    monkeypatch.setattr(VLMRunner, "generate", altered)
    assert run(tiny_cell("extract"))["correct"] is False


def test_decode_state_left_unchanged(monkeypatch):
    """Decode steps that never write their k/v into the cache."""
    from vision_compression_project_tpu_torch.models import layers

    real = layers.Attention.decode

    def stale(self, x, cache, pos):
        saved = {k: v.clone() for k, v in cache.items()}
        out, _ = real(self, x, cache, pos)
        for k in cache:
            cache[k].copy_(saved[k])
        return out, cache

    monkeypatch.setattr(layers.Attention, "decode", stale)
    assert run(tiny_cell("extract"))["correct"] is False
