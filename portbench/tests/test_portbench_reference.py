"""The plain reference against the port at the tiny and tiny_moe presets on
the CPU, in float32: the loss, every gradient, and the logits of greedy
extraction through the port's KV cache."""

import numpy as np
import pytest
import torch

from conftest import TINY_TRAFFIC, tiny_config
from portbench import harness, traffic, weights
from portbench.reference.model import Reference
from portbench.reference.precision import exact_float32
from portbench.reference.tokens import BOS_ID, TASK_EXTRACT_ID, extract_mask


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_loss_and_gradients_match_the_port(preset):
    from vision_compression_project_tpu_torch.models.vlm import OpticalVLM
    from vision_compression_project_tpu_torch.train.data import device_batch
    from vision_compression_project_tpu_torch.train.train_step import vlm_loss

    cfg = tiny_config(preset, "float32")
    batch = traffic.host_batches(TINY_TRAFFIC["train"], cfg, 7)[0]
    w = weights.make(cfg, 7, "cpu")
    model = OpticalVLM(harness.vlm_config(cfg))
    model.load_state_dict(w)
    loss = vlm_loss(model, device_batch(harness.vlm_config(cfg), batch, device="cpu"))
    loss.backward()
    with exact_float32():
        params = {k: v.float().clone().requires_grad_(True) for k, v in w.items()}
        ref_loss = Reference(cfg, params).loss(torch.from_numpy(batch["pages_u8"]),
                                               torch.from_numpy(batch["token_ids"]).long())
        grads = torch.autograd.grad(ref_loss, list(params.values()))
    # The port's preprocess hands the encoder bf16 patch tokens whatever the
    # model's dtype; the reference keeps them f32: 1e-4 of the loss, not 1e-6.
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= 1e-4 * abs(float(ref_loss.detach()))
    named = dict(model.named_parameters())
    for (k, p), g in zip(params.items(), grads):
        got = named[k].grad
        # The bf16 patch tokens move the encoder's gradients by up to 3e-3 of the leaf's largest.
        assert float((got - g).abs().max()) <= 5e-3 * float(g.abs().max()) + 1e-9, k


def test_served_logits_match_the_ports_greedy_decode():
    from vision_compression_project_tpu_torch.models.vlm import VLMRunner

    cfg = tiny_config("tiny", "float32")
    pages = traffic.host_batches(TINY_TRAFFIC["extract"], cfg, 5)[0]["pages_u8"]
    w = weights.make(cfg, 5, "cpu")
    runner = VLMRunner(harness.vlm_config(cfg), params=w, device="cpu")
    toks = runner.extract_batch_async(pages, [1, 2, 3, 4], max_new=16)[0].numpy()
    mask = torch.from_numpy(extract_mask(cfg["decoder"]["tokenizer"], cfg["decoder"]["vocab"]))
    ref = Reference(cfg, {k: v.float() for k, v in w.items()})
    for row in range(pages.shape[0]):
        served = [int(t) for t in toks[row] if t != 256]
        logits = ref.served_logits(torch.from_numpy(pages[row]), [BOS_ID, TASK_EXTRACT_ID], served) + mask
        best = logits.max(dim=-1).values
        picked = logits.gather(1, torch.tensor(served)[:, None])[:, 0]
        assert float((best - picked).max()) <= 1e-4


def test_weights_same_seed_same_values():
    cfg = tiny_config("tiny_moe")
    a, b = weights.make(cfg, 2**31 + 9, "cpu"), weights.make(cfg, 2**31 + 9, "cpu")
    c = weights.make(cfg, 2**31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.weight"], c["proj.weight"])
    assert a["decoder.blocks.0.mlp.w_gate"].dtype == torch.bfloat16
    assert a["decoder.blocks.0.mlp.router.weight"].dtype == torch.float32


def test_inputs_same_seed_same_values_rows_differ():
    cfg = tiny_config("tiny")
    a = traffic.host_batches(TINY_TRAFFIC["train"], cfg, 11)
    b = traffic.host_batches(TINY_TRAFFIC["train"], cfg, 11)
    assert all(np.array_equal(x["pages_u8"], y["pages_u8"]) and np.array_equal(x["token_ids"], y["token_ids"])
               for x, y in zip(a, b))
    rows = np.concatenate([x["token_ids"] for x in a])
    assert len({r.tobytes() for r in rows}) == len(rows)
