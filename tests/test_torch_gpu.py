"""Tests of the port that need the card: the hand-written kernels against
their plain versions on CUDA tensors, the vector index's search and the glyph
renderer on the card against the same on the CPU, the shipped weights read on
the card's machine, /ingest from a PDF on the card, the HTTP server's
/chat on the card, the neural embedder and MaxSim retrieval on the card, and
the retrieval harness's 40-page hit@3, the train_answer command line at
ocr_bpe's training shapes, and the multi-device layer (the ring's per-rank
steps and the sharded search's per-shard step for virtual ranks, and
search_sharded on one NCCL rank started by the launcher), and sharded
training (the ring's backward for virtual ranks, the sharded step on a
one-rank NCCL mesh, a prod MoE block's TP/EP virtual ranks; on 4 cards the
sharded steps against one card's, which skips on fewer), and pipeline-
parallel training (the pipelined f32 step on the card against the CPU's; on
4 cards ocr_real's pipelined steps at data 2 x model 2 against one card's,
and the dry run over NCCL on 2 and 4 cards, which skip on fewer), and the
gated short conv's kernels against ShortConv's plain path (`-k short_conv`).
They skip without a CUDA device.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On the GPU machine, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.models import VLMRunner, get_preset, layers
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID, TASK_EXTRACT_ID
from vision_compression_project_tpu_torch.index.vector_index import VectorIndex
from vision_compression_project_tpu_torch.ops.attention import (
    attention_lse, flash_attention, flash_attention_bwd, mha_reference,
)
from vision_compression_project_tpu_torch.ops.topk import (
    NEG_INF, cosine_topk, masked_similarity, masked_similarity_reference,
)

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (2, 4, 4, 256, 64, None, False),
        (2, 4, 4, 256, 64, None, True),
        (2, 8, 2, 128, 32, [128, 57], False),
        (3, 6, 2, 200, 64, [200, 0, 37], True),
        (2, 6, 2, 1088, 64, [1026, 1087], True),
        (1, 2, 1, 5, 32, [3], True),
        # The shapes of the main paths: ocr_real's encoder local and global
        # calls and decoder prefill, ocr_bpe's blank-page global call and
        # answer prefill.
        (64, 6, 6, 256, 32, None, False),
        (4, 6, 6, 1024, 64, None, False),
        (4, 6, 2, 1088, 64, [1026] * 4, True),
        (1, 4, 4, 256, 64, None, False),
        (1, 8, 4, 768, 32, None, True),
        # The neural embedder's calls: non-causal, each text's length as
        # kv_len (0 for an empty text), S padded to 128..1024.
        (4, 8, 8, 1024, 64, [0, 37, 1024, 600], False),
        (3, 8, 8, 128, 64, [1, 128, 0], False),
        # Ragged S (not a multiple of 64 or 16), key lengths 0 and 1, GQA 3:1.
        (2, 6, 2, 77, 64, [77, 1], False),
        (3, 3, 1, 333, 32, [0, 1, 250], True),
        (2, 6, 2, 130, 64, [1, 0], True),
        # prod's page batch: windows, the global stage at head_dim 96, the
        # decoder prefill at 128 (GQA 4:1, 258 keys of 320); and ragged cases
        # at both new head dims.
        (64, 12, 12, 256, 64, None, False),
        (4, 16, 16, 256, 96, None, False),
        (4, 16, 4, 320, 128, [258] * 4, True),
        (3, 8, 2, 333, 96, [0, 1, 333], True),
        (3, 8, 2, 333, 128, [0, 1, 200], True),
        (2, 4, 1, 77, 128, [77, 5], False),
        # The bf16 route's edges: mixC's decoder (Sq 1534, every key valid);
        # one row past a 64-row half and a 128-row work item; D = 128 at GQA
        # 16:4 with key lengths 0, 1 and 200.
        (2, 6, 2, 1534, 64, [1534, 1534], True),
        (2, 6, 6, 65, 64, None, True),
        (2, 6, 6, 65, 32, [65, 3], False),
        (2, 6, 2, 129, 32, None, False),
        (2, 8, 8, 129, 96, [129, 64], True),
        (3, 16, 4, 333, 128, [0, 1, 200], False),
        (3, 16, 4, 333, 128, [0, 1, 200], True),
        # The ring's hops of 4 ranks at full width: ocr_real's decoder prefill
        # (272-row chunks, clamped key lengths down to 0), prod's (80 rows at
        # 128) and ocr_real's global call (256 rows, not causal).
        (4, 6, 2, 272, 64, [272, 0, 156, 271], True),
        (4, 6, 2, 272, 64, [272, 2, 0, 272], False),
        (4, 16, 4, 80, 128, [80, 2, 80, 0], True),
        (4, 6, 6, 256, 64, None, False),
    ],
)
def test_kernel_matches_plain(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    """K1 against mha_reference within TOL, one launch; with `lse=` the same
    output to the bit and the row log-sum-exp against attention_lse (1e-5 of
    the largest |lse| in f32, 1e-4 in bf16), +inf exactly on rows without
    keys."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = kernels.launches["flash_attention"]
    got = flash_attention(q, k, v, kv_len=kv, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == before + 1
    want = mha_reference(q, k, v, kv_len=kv, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    assert torch.equal(kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=lse), got)
    want_lse = attention_lse(q, k, v, kv_len=kv, causal=causal)
    inf = torch.isinf(want_lse)
    assert torch.equal(torch.isposinf(lse), inf)
    if bool((~inf).any()):
        tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
        assert (lse[~inf] - want_lse[~inf]).abs().max().item() <= tol * want_lse[~inf].abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_forward_kernel_is_deterministic(cuda, dtype, d):
    """Two runs on the same inputs give bit-identical O and lse: each row is
    summed by one warpgroup in a fixed order, whatever block takes it."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((4, 8, 1534, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((4, 2, 1534, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    kv = torch.tensor([1534, 700, 1, 0], dtype=torch.int32, device=cuda)
    runs = []
    for _ in range(2):
        lse = torch.empty((4, 8, 1534), dtype=torch.float32, device=cuda)
        runs.append((kernels.flash_attention_fwd(q, k, v, kv, True, d ** -0.5, lse=lse), lse))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal", [(32, False), (64, True), (96, False), (128, True)])
def test_forward_kernel_in_cuda_graph(cuda, dtype, d, causal):
    """A call captured in a CUDA graph and replayed gives what the same call
    gives eagerly, bit for bit: O and lse (the tensor maps are kernel
    parameters, kept by the capture), also after the inputs change in
    place."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, h, hkv, s = 2, 8, 4, 333
    q = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    kv = torch.tensor([333, 100], dtype=torch.int32, device=cuda)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=lse)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=lse)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        eager_lse = torch.empty_like(lse)
        eager = kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=eager_lse)
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(lse, eager_lse)
        q.copy_(torch.randn(q.shape, generator=g, device=cuda).to(dtype))
        kv.fill_(200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_head_split_views_in_place(cuda, dtype):
    """q/k/v as the attention layer makes them (head-split views of a
    (B, S, H * D) projection) give the result of contiguous copies, and the
    output is a (B, H, S, D) view of a contiguous (B, S, H, D) tensor."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, hkv, d = 2, 300, 6, 2, 64
    proj = torch.randn((b, s, (h + 2 * hkv) * d), generator=g, device=cuda).to(dtype)
    q = proj[..., : h * d].view(b, s, h, d).transpose(1, 2)
    k = proj[..., h * d : (h + hkv) * d].view(b, s, hkv, d).transpose(1, 2)
    v = proj[..., (h + hkv) * d :].view(b, s, hkv, d).transpose(1, 2)
    kv = torch.tensor([300, 211], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, kv_len=kv, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_len=kv, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()
    plain = mha_reference(q, k, v, kv_len=kv, causal=True)
    assert (got.float() - plain.float()).abs().max().item() <= TOL[dtype]


def test_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros((1, 2, 128, 48), device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    assert kernels.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 128])
def test_backward_kernel_refuses_prod_head_dims(cuda, dtype, d):
    """prod's head dims (96 in its global vision stage, 128 in its decoder)
    train on the card: a gradient through them is the backward kernel, one
    launch, within the limits of the gradient tests above of the plain
    flash_attention_bwd, and bit-identical on a second call. The backward
    still refuses a head dim it does not take (48), before any launch."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((2, 8, 200, d), generator=g, device=cuda).to(dtype).requires_grad_()
    kv = torch.randn((2, 2, 200, d), generator=g, device=cuda).to(dtype)
    k, v = kv.clone().requires_grad_(), kv.flip(2).contiguous().requires_grad_()
    w = torch.randn((2, 8, 200, d), generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([200, 131], dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    out = flash_attention(q, k, v, kv_len=kv_len, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), w)
    torch.cuda.synchronize()
    assert (kernels.launches["flash_attention"], kernels.launches["flash_attention_bwd"]) == (1, 1)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), kv_len, w, True, d ** -0.5)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, wt in zip(grads, want):
        assert got.dtype == dtype and got.shape == wt.shape
        err = (got.float() - wt.float()).abs().max().item()
        assert bool(torch.isfinite(got).all()) and err <= tol * wt.float().abs().max().item()
    lse = torch.empty((2, 8, 200), dtype=torch.float32, device=cuda)
    args = [t.detach() for t in (q, k, v)]
    o = kernels.flash_attention_fwd(*args, kv_len, True, d ** -0.5, lse=lse)
    first = kernels.flash_attention_bwd(*args, o, w, lse, kv_len, True, d ** -0.5)
    second = kernels.flash_attention_bwd(*args, o, w, lse, kv_len, True, d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    q48 = torch.zeros((1, 4, 128, 48), dtype=dtype, device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="head_dim"):
        kernels.flash_attention_bwd(q48, q48, q48, q48, q48, torch.zeros((1, 4, 128), device=cuda),
                                    None, False, 0.1)
    assert kernels.launches == before


def test_runner_first_logits_card_vs_cpu(cuda):
    cfg = get_preset("tiny")
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
        decoder=dataclasses.replace(cfg.decoder, dtype="float32"),
    )
    page = torch.randint(0, 256, (1, 90, 70), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0)).numpy()
    out = []
    for device in (cuda, "cpu"):
        runner = VLMRunner(cfg, seed=0, device=device)
        vis = runner.encode(runner.preprocess_patches(page))
        ids, lens = runner.pad_prompts([[BOS_ID, TASK_EXTRACT_ID]])
        logits, _, _ = runner.first_logits(ids, lens, vis, 128)
        out.append(logits.cpu())
    assert (out[0] - out[1]).abs().max().item() <= 1e-3


# Masked similarity of unit vectors: the same f32 products summed in another
# order (a warp's shuffle tree against cuBLAS's or the CPU's order).
SIM_ATOL = 1e-5


def _similarity_inputs(device, n, d, b, emb_dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((n, d), generator=g, device=device)
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(emb_dtype)
    q = torch.randn((b, d), generator=g, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    mask = (torch.rand((n,), generator=g, device=device) > 0.5).float()
    return emb, q, mask


@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,b", [(131072, 512, 1), (1000, 512, 3), (4099, 64, 8)])
def test_similarity_kernel_matches_plain(cuda, emb_dtype, n, d, b):
    emb, q, mask = _similarity_inputs(cuda, n, d, b, emb_dtype)
    before = kernels.launches["masked_similarity"]
    got = masked_similarity(emb, q, mask)
    torch.cuda.synchronize()
    assert kernels.launches["masked_similarity"] == before + 1
    want = masked_similarity_reference(emb, q, mask)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    off = mask <= 0
    assert bool((got[:, off] == NEG_INF).all())
    assert (got - want).abs().max().item() <= SIM_ATOL


def test_similarity_kernel_refuses(cuda):
    emb, q, mask = _similarity_inputs(cuda, 256, 512, 2, torch.float32)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.masked_similarity(emb, q.cpu(), mask)
    with pytest.raises(ValueError, match="D ="):
        masked_similarity(emb[:, :510].contiguous(), q[:, :510].contiguous(), mask)
    with pytest.raises(ValueError, match="queries"):
        kernels.masked_similarity(emb, q.repeat(5, 1), mask)
    assert kernels.launches == before


def test_similarity_any_number_of_queries(cuda):
    """ops.topk.masked_similarity scores any batch: in chunks of the kernel's
    limit, one launch per chunk, one launch for a batch within it."""
    emb, q, mask = _similarity_inputs(cuda, 131072, 512, 32, torch.float32)
    limit = kernels.SIMILARITY_MAX_QUERIES
    for b in (1, limit, limit + 1, 32):
        before = kernels.launches["masked_similarity"]
        got = masked_similarity(emb, q[:b], mask)
        torch.cuda.synchronize()
        assert kernels.launches["masked_similarity"] == before + -(-b // limit)
        want = masked_similarity_reference(emb, q[:b], mask)
        assert got.shape == (b, 131072)
        assert bool((got[:, mask <= 0] == NEG_INF).all())
        assert (got - want).abs().max().item() <= SIM_ATOL


def test_index_search_card_equals_cpu(cuda):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3000, 512)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    records = [{"doc_id": "ab"[i % 2], "page": i, "content": f"p{i}"} for i in range(3000)]
    ids = [f"m{i}" for i in range(3000)]
    queries = rng.standard_normal((2, 512)).astype(np.float32)
    on_card, on_cpu = VectorIndex(512, device=cuda), VectorIndex(512, device="cpu")
    for index in (on_card, on_cpu):
        index.add(rows[:1000], records[:1000], ids[:1000])
        index.add(rows[1000:], records[1000:], ids[1000:])  # grows 1024 -> 4096
    for doc in (None, "b"):
        before = kernels.launches["masked_similarity"]
        got = on_card.search(queries, top_k=8, doc_id=doc)
        assert kernels.launches["masked_similarity"] == before + 1
        want = on_cpu.search(queries, top_k=8, doc_id=doc)
        assert [[r["id"] for r in res] for res in got] == [[r["id"] for r in res] for res in want]
        for g, w in zip(got, want):
            assert max(abs(a["score"] - b["score"]) for a, b in zip(g, w)) <= SIM_ATOL
    vals, idx = cosine_topk(on_card._rows, torch.from_numpy(queries).to(cuda), on_card._mask_for("a"), 8)
    assert vals.shape == idx.shape == (2, 8)


def test_index_search_32_queries_card_equals_cpu(cuda):
    """A batch of 32 queries (scripts/bench_index.py's default) on the card:
    the same ids in the same order as the CPU search, scores within SIM_ATOL."""
    rng = np.random.default_rng(1)
    n = 5000
    rows = rng.standard_normal((n, 512)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    records = [{"doc_id": "abc"[i % 3], "page": i, "content": f"p{i}"} for i in range(n)]
    ids = [f"m{i}" for i in range(n)]
    queries = rng.standard_normal((32, 512)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    on_card, on_cpu = VectorIndex(512, device=cuda), VectorIndex(512, device="cpu")
    for index in (on_card, on_cpu):
        index.add(rows, records, ids)
    for doc in (None, "c"):
        got = on_card.search(queries, top_k=10, doc_id=doc)
        want = on_cpu.search(queries, top_k=10, doc_id=doc)
        assert len(got) == 32
        assert [[r["id"] for r in res] for res in got] == [[r["id"] for r in res] for res in want]
        for g, w in zip(got, want):
            assert max(abs(a["score"] - b["score"]) for a, b in zip(g, w)) <= SIM_ATOL


def test_shipped_weights_decode_to_the_digests(cuda):
    """The port's checkpoint reader, built and run on this machine, decodes
    both shipped checkpoints to the committed per-tensor SHA-256s."""
    from vision_compression_project_tpu_torch import config
    from vision_compression_project_tpu_torch.train.checkpoint import load_params, param_digests, shipped_digests

    want = shipped_digests()
    for preset in ("ocr_real", "ocr_bpe"):
        ckpt = config.shipped_checkpoint_dir(preset)
        assert ckpt is not None, f"checkpoints/default/{preset} is missing (see .chiprunignore)"
        assert param_digests(load_params(ckpt)) == want[preset]


def _glyph_pages(tmp_path, dpi):
    from vision_compression_project_tpu_torch.ops.glyph_render import pack_primitives
    from vision_compression_project_tpu_torch.raster import PdfDocument, make_pdf

    pdf = make_pdf(["Render Parity\nThe quick brown fox jumps over the lazy dog.\n0123456789 !@#$%^&*()",
                    "Second Page\nAnother block of text to rasterize faithfully."], tmp_path / "d.pdf")
    with PdfDocument(pdf) as doc:
        prims = [doc.page_primitives(i, dpi=dpi) for i in range(2)]
        h, w = doc.render_page(0, dpi=dpi).shape[:2]
    return pack_primitives(prims), h, w


@pytest.mark.parametrize("dpi", [72, 93, 150])
def test_glyph_render_card_equals_cpu(cuda, tmp_path, dpi):
    """The page drawn on the card (bf16 indicator products) equals the page
    drawn on the CPU (f32), pixel for pixel."""
    from vision_compression_project_tpu_torch.ops.glyph_render import render_pages_from_glyphs

    arrays, h, w = _glyph_pages(tmp_path, dpi)
    on_card = render_pages_from_glyphs(*(torch.from_numpy(a).to(cuda) for a in arrays), h=h, w=w)
    on_cpu = render_pages_from_glyphs(*(torch.from_numpy(a) for a in arrays), h=h, w=w)
    assert on_card.device.type == "cuda" and (on_cpu < 128).any()
    assert torch.equal(on_card.cpu(), on_cpu)


def test_extract_pdf_on_the_card(cuda, tmp_path):
    """extract_pdf_to_page_jsons on a 4-page PDF on the card, one batch by
    glyph transport: 14 flash-attention launches (ocr_real's encoder and
    prefill) and no backward launch, one page JSON with the four keys per
    page."""
    import json

    from vision_compression_project_tpu_torch.pipeline.extract import extract_pdf_to_page_jsons
    from vision_compression_project_tpu_torch.raster import make_pdf

    pdf = make_pdf([f"Page {i}\nThe audit team reviewed {i * 7} samples." for i in range(1, 5)],
                   tmp_path / "d.pdf", font_size=24)
    runner = VLMRunner(get_preset("ocr_real"), seed=0, max_new_default=16, device=cuda)
    kernels.reset_launch_counts()
    stats = extract_pdf_to_page_jsons(pdf, tmp_path / "pages", dpi=93, engine="vlm", batch_size=4,
                                      runner=runner, save_images=False)
    torch.cuda.synchronize()
    assert kernels.launches == {name: 14 if name == "flash_attention" else 0 for name in kernels.launches}
    assert stats == {"pages_total": 4, "processed_pages": [1, 2, 3, 4], "failed_pages": []}
    for i in range(1, 5):
        rec = json.loads((tmp_path / "pages" / f"page_{i:03d}.json").read_text())
        assert set(rec) == {"page_number", "markdown", "entities", "summary"} and rec["page_number"] == i


def test_server_on_the_card_answers_chat_with_one_similarity_launch(cuda, tmp_path):
    """The port's HTTP server with its embedder and index on the card: one
    POST /chat over a small ingested document answers 200 in the response
    shape, its pages retrieved by exactly one masked-similarity launch."""
    import json
    import threading
    import urllib.request

    from vision_compression_project_tpu_torch.index import IndexStore
    from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
    from vision_compression_project_tpu_torch.models.embedder import HashNGramEmbedder
    from vision_compression_project_tpu_torch.pipeline.ingest import ingest_pages_dir
    from vision_compression_project_tpu_torch.serve.httpd import create_server

    pages = tmp_path / "pages"
    pages.mkdir()
    for i, text in enumerate(["Solar panels convert sunlight into electricity.",
                              "Wind turbines generate power from moving air.",
                              "Batteries store renewable energy for the night."], 1):
        (pages / f"page_{i:03d}.json").write_text(json.dumps(
            {"page_number": i, "markdown": text, "entities": [], "summary": text}))
    server = create_server(host="127.0.0.1", port=0, base_tmp=tmp_path / "tmp")
    state = server.vcp_state
    state._embedder = HashNGramEmbedder(EmbedderConfig(), device=cuda)
    state._store = IndexStore(tmp_path / "index", dim=state._embedder.dim, device=cuda)
    ingest_pages_dir(pages, "doc.pdf", "doc-1", tmp_path / "tmp" / "doc-1" / "supermemory_manifest.json",
                     embedder=state._embedder, store=state._store)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        kernels.reset_launch_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/chat",
            data=json.dumps({"doc_id": "doc-1", "question": "How is energy stored?", "top_k": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
        torch.cuda.synchronize()
        assert kernels.launches["masked_similarity"] == 1
    finally:
        server.shutdown()
        server.server_close()
    assert status == 200 and list(body) == ["doc_id", "answer_md", "retrieved"]
    assert body["answer_md"] and len(body["retrieved"]) == 2
    assert {r["page"] for r in body["retrieved"]} <= {1, 2, 3}


NEURAL_TEXTS = ["", "What is the efficiency of solar panels?", "Ωmega ünïcödé — 日本語のテキスト 🙂",
                "The cache module stores pages. " * 40, "a" * 1500, "short"]


def test_neural_embedder_card_matches_plain(cuda, monkeypatch):
    """The full-width neural embedder on the card (flash-attention kernel,
    depth launches per call) against the same weights with the plain
    attention on the card, bf16: 2e-2 on unit vectors, as the reference's
    padding tolerance. A batch of empty texts pads to 8 and launches nothing."""
    from vision_compression_project_tpu_torch.models import layers
    from vision_compression_project_tpu_torch.models.configs import EmbedderConfig
    from vision_compression_project_tpu_torch.models.embedder import NeuralEmbedder

    cfg = EmbedderConfig()
    embedder = NeuralEmbedder(cfg, seed=0, device=cuda)
    assert embedder.padded_length(NEURAL_TEXTS) == cfg.max_seq
    kernels.reset_launch_counts()
    got = embedder.embed(NEURAL_TEXTS)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == cfg.depth
    with monkeypatch.context() as mp:
        mp.setattr(layers, "use_flash", lambda s, d: False)
        want = embedder.embed(NEURAL_TEXTS)
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 2e-2
    assert (got[0] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[1:], axis=1), 1.0, atol=1e-5)
    kernels.reset_launch_counts()
    assert (embedder.embed(["", ""]) == 0).all() and kernels.launches["flash_attention"] == 0


def test_maxsim_search_card_equals_cpu(cuda):
    """The same multi-vector index on the card and on the CPU: the same pages
    in the same order, ties included (12 copies of one page's set, more than
    k), scores within 1e-5."""
    from vision_compression_project_tpu_torch.index import MultiVectorIndex

    rng = np.random.default_rng(0)
    dim = 512
    sets = [rng.standard_normal((int(rng.integers(1, 9)), dim)).astype(np.float32) for _ in range(3000)]
    sets = [s / np.linalg.norm(s, axis=1, keepdims=True) for s in sets]
    for i in range(1000, 1012):
        sets[i] = sets[999]
    records = [{"doc_id": "a" if i % 2 else "b", "page": i + 1, "content": f"p{i}"} for i in range(3000)]
    ids = [f"m{i}" for i in range(3000)]
    on_card = MultiVectorIndex(dim, device=cuda)
    on_cpu = MultiVectorIndex(dim, device="cpu")
    for index in (on_card, on_cpu):
        index.add(sets, records, memory_ids=ids)
    for queries, doc in ((sets[999][:2], None), (sets[999][:1], "a"), (sets[5], "b")):
        got = on_card.search(queries, top_k=8, doc_id=doc)
        want = on_cpu.search(queries, top_k=8, doc_id=doc)
        assert [r["id"] for r in got] == [r["id"] for r in want]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(got, want)) <= 1e-5
    assert [r["id"] for r in on_card.search(sets[999], top_k=8)] == [f"m{i}" for i in range(999, 1007)]


def test_eval_retrieval_40_pages_on_the_card(cuda, monkeypatch, capsys):
    """The retrieval harness's default form on the card: hit@3 over 40 pages
    is 1.000 in both modes with the hash embedder (as the JAX package's
    harness gives on the CPU); the neural rows are printed, not held to a
    number (their weights are random)."""
    import dataclasses

    from vision_compression_project_tpu_torch import config
    from vision_compression_project_tpu_torch.scripts import eval_retrieval

    monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, device="cuda"))
    pages, questions = eval_retrieval.build_corpus(40)
    for cfg in ("single:hash", "multi:hash", "single:neural", "multi:neural"):
        mode, backend = cfg.split(":")
        score = eval_retrieval.evaluate(mode, backend, pages, questions, 3)
        with capsys.disabled():
            print(f"{cfg}: {score:.3f}")
        if backend == "hash":
            assert score == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        # Training shapes of ocr_real at a small batch (encoder windows and
        # global, decoder over 1024 + 510 tokens), the embedder's documents
        # (ragged), and a ragged S.
        (32, 6, 6, 256, 32, None, False),
        (2, 6, 6, 1024, 64, None, False),
        (2, 6, 2, 1534, 64, None, True),
        (4, 8, 8, 256, 64, [256, 17, 130, 1], False),
        (3, 6, 2, 130, 64, [130, 2, 77], True),
        # ocr_bpe's training shapes at a small batch (train_answer, text_len
        # 320): the global encoder, and the decoder over 256 + 319 tokens,
        # causal at head_dim 32 with GQA 8:4.
        (2, 4, 4, 256, 64, None, False),
        (2, 8, 4, 575, 32, None, True),
        # prod_train's global vision call (head_dim 96) and its decoder over
        # 256 + 510 tokens (head_dim 128, causal, GQA 16:4), at batch 2.
        (2, 16, 16, 256, 96, None, False),
        (2, 16, 4, 766, 128, None, True),
    ],
)
def test_flash_attention_gradient_matches_plain_autograd(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    """FlashAttentionFn on the card (K1 forward with its log-sum-exp, the
    backward kernel, one launch each) against autograd through mha_reference
    on the card: the largest error of the output and of dq, dk, dv over the
    reference's largest value, 2e-2 in bf16 (P and dS enter the kernel's
    products as bf16) and 1e-4 in f32 (f32 arithmetic on the same inputs,
    rounded to the input type at the end)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((b, heads, s, d), generator=g, device=cuda).to(dtype) for heads in (h, hkv, hkv))
    w = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = flash_attention(*leaves, kv_len=kv, causal=causal)
    grads = torch.autograd.grad(out, leaves, w)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == 1
    assert kernels.launches["flash_attention_bwd"] == 1
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = mha_reference(*ref_leaves, kv_len=kv, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, w)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip((out, *grads), (ref, *ref_grads)):
        assert got.dtype == dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        assert bool(torch.isfinite(got).all()) and err <= tol * want.float().abs().max().item()


def test_ocr_real_train_step_card_equals_cpu(cuda):
    """One ocr_real train_step at batch 2 in f32, the same seeded weights and
    batch on the card and on the CPU: every parameter's gradient within 1e-3
    of its largest value plus 1e-6, the loss within 1e-4, the parameters after
    the step within 2 x lr (a gradient near 0 may change sign between the two
    and move its parameter by lr either way). The step launches K1 28 times
    (8 encoder + 6 decoder blocks, forward and remat recompute) and its
    backward kernel 14 times, once a block."""
    from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID
    from vision_compression_project_tpu_torch.train.train_step import make_train_state, train_step

    cfg = get_preset("ocr_real")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                              decoder=dataclasses.replace(cfg.decoder, dtype="float32"))
    rng = np.random.default_rng(0)
    v = cfg.vision
    patches = torch.tensor(rng.standard_normal((2, v.grid * v.grid, v.patch * v.patch * 3)), dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, cfg.decoder.vocab, size=(2, 511)))
    ids[:, 0] = BOS_ID
    lr = 1e-5
    results = {}
    for device in ("cpu", cuda):
        model, opt, state = make_train_state(cfg, device=device, seed=0, lr=lr)
        batch = {"patch_tokens": patches.to(device), "token_ids": ids.to(device)}
        kernels.reset_launch_counts()
        state, loss = train_step(model, opt, state, batch)
        grads = {k: p.grad.float().cpu() for k, p in state.params.items()}
        params = {k: p.detach().cpu() for k, p in state.params.items()}
        results[str(device)] = (float(loss), grads, params,
                                (kernels.launches["flash_attention"], kernels.launches["flash_attention_bwd"]))
    (cpu_loss, cpu_grads, cpu_params, _), (loss, grads, params, launches) = results["cpu"], results["cuda"]
    assert launches == (28, 14)
    assert abs(loss - cpu_loss) <= 1e-4
    for name, want in cpu_grads.items():
        got = grads[name]
        assert bool(torch.isfinite(got).all()), name
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-6, name
        assert (params[name] - cpu_params[name]).abs().max().item() <= 2 * lr, name


# The backward kernel against its plain version at the training shapes (small
# batches) and ragged ones: key lengths 0 and 1, GQA 3:1, S not a multiple of
# 16 or 64.
BWD_CASES = [
    (4, 6, 6, 256, 32, None, False),
    (2, 6, 6, 1024, 64, None, False),
    (2, 6, 2, 1534, 64, None, True),
    (4, 8, 8, 256, 64, [256, 17, 130, 1], False),
    (3, 6, 2, 130, 64, [130, 0, 77], True),
    (3, 3, 1, 77, 32, [77, 1, 0], False),
    (2, 4, 4, 256, 64, None, False),
    (2, 8, 4, 575, 32, None, True),
    # prod_train's calls at head_dim 96 and 128 (small batches), and ragged
    # cases at both: key lengths 0 and 1, S not a multiple of 16, GQA 4:1.
    (2, 16, 16, 256, 96, None, False),
    (1, 16, 4, 766, 128, None, True),
    (3, 8, 2, 333, 96, [333, 0, 1], True),
    (3, 8, 2, 333, 128, [333, 1, 200], False),
    (2, 4, 1, 77, 128, [77, 5], True),
    # The warp-specialised bf16 kernel's 128-key and 128-row blocks: each
    # head_dim at GQA 1:1, 3:1 and 4:1, lengths 1534, 766, 575 and 200 (not
    # multiples of 64 or 128), ragged rows with a 0, causal and not.
    (2, 6, 2, 766, 32, [766, 0], True),
    (2, 8, 2, 200, 32, None, False),
    (2, 3, 1, 575, 64, [575, 300], False),
    (2, 8, 2, 200, 64, [0, 200], True),
    (1, 12, 4, 1534, 96, None, True),
    (2, 8, 8, 575, 96, [575, 0], False),
    (2, 8, 2, 200, 128, None, True),
    (1, 6, 2, 1534, 128, [1534], False),
]


def _bwd_inputs(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, w = (torch.randn((b, heads, s, d), generator=g, device=cuda).to(dtype) for heads in (h, hkv, hkv, h))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    o = kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=lse)
    return q, k, v, w, kv, o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,kv_len,causal", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    """kernels.flash_attention_bwd against the plain flash_attention_bwd on
    the same inputs, the same relative limits as the gradient test above; one
    launch; a batch row with kv_len == 0 gets exactly zero gradients."""
    q, k, v, w, kv, o, lse = _bwd_inputs(cuda, dtype, b, h, hkv, s, d, kv_len, causal)
    kernels.reset_launch_counts()
    got = kernels.flash_attention_bwd(q, k, v, o, w, lse, kv, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention_bwd"] == 1
    want = flash_attention_bwd(q, k, v, kv, w, causal, d ** -0.5)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        err = (gt.float() - wt.float()).abs().max().item()
        assert bool(torch.isfinite(gt).all()) and err <= tol * wt.float().abs().max().item()
    for i, n in enumerate(kv_len or []):
        if n == 0:
            assert all(float(gt[i].abs().max()) == 0.0 for gt in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,kv_len,causal", BWD_CASES)
def test_forward_lse_matches_plain(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    """The log-sum-exp K1's forward writes against attention_lse on the same
    inputs, within 1e-5 of the largest |lse| in f32 and 1e-4 in bf16 (the
    same f32 scores of bf16 inputs, summed in another order, through ex2 in
    log2 units); +inf exactly where a row has no key. The output is the one
    the kernel gives without lse."""
    q, k, v, _, kv, o, lse = _bwd_inputs(cuda, dtype, b, h, hkv, s, d, kv_len, causal)
    want = attention_lse(q, k, v, kv_len=kv, causal=causal)
    torch.cuda.synchronize()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all())
    scale = want[~inf].abs().max().item()
    tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
    assert (lse[~inf] - want[~inf]).abs().max().item() <= tol * scale
    assert torch.equal(o, flash_attention(q, k, v, kv_len=kv, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_backward_kernel_is_deterministic(cuda, dtype, d):
    """Two runs on the same inputs give bit-identical dq, dk and dv: every
    element is summed by one thread in a fixed order, with no atomics."""
    q, k, v, w, kv, o, lse = _bwd_inputs(cuda, dtype, 4, 6, 2, 1534, d, [1534, 700, 1, 1200], True)
    first = kernels.flash_attention_bwd(q, k, v, o, w, lse, kv, True, d ** -0.5)
    second = kernels.flash_attention_bwd(q, k, v, o, w, lse, kv, True, d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# Query and key lengths that differ, as a ring hop's call has them (the
# kernel's causal mask is key <= query row, from the first row of each).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,kv_len,causal", [
    (2, 6, 2, 384, 1534, 64, None, False),
    (2, 6, 2, 1534, 384, 64, [384, 100], False),
    (1, 16, 4, 192, 766, 128, None, False),
    (2, 8, 8, 200, 575, 32, [575, 0], False),
    (2, 6, 2, 256, 512, 96, None, True),
    (2, 6, 6, 575, 200, 32, [200, 77], True),
])
def test_backward_kernel_matches_plain_across_lengths(cuda, dtype, b, h, hkv, sq, sk, d, kv_len, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, w = (torch.randn((b, h, sq, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=cuda)
    o = kernels.flash_attention_fwd(q, k, v, kv, causal, d ** -0.5, lse=lse)
    got = kernels.flash_attention_bwd(q, k, v, o, w, lse, kv, causal, d ** -0.5)
    want = flash_attention_bwd(q, k, v, kv, w, causal, d ** -0.5)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        err = (gt.float() - wt.float()).abs().max().item()
        assert bool(torch.isfinite(gt).all()) and err <= tol * wt.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_backward_kernel_reads_head_split_views_in_place(cuda, dtype, d):
    """q, k, v, o and dO as head-split views of (B, S, H * D) tensors give
    the gradients of contiguous copies, bit for bit (the tensor maps carry
    the strides), in (B, H, S, D) views of contiguous (B, S, H, D) tensors."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, s, h, hkv = 2, 575, 6, 2
    proj = torch.randn((b, s, (h + 2 * hkv) * d), generator=g, device=cuda).to(dtype)
    q = proj[..., : h * d].view(b, s, h, d).transpose(1, 2)
    k = proj[..., h * d : (h + hkv) * d].view(b, s, hkv, d).transpose(1, 2)
    v = proj[..., (h + hkv) * d :].view(b, s, hkv, d).transpose(1, 2)
    w = torch.randn((b, s, h * d), generator=g, device=cuda).to(dtype).view(b, s, h, d).transpose(1, 2)
    kv = torch.tensor([575, 300], dtype=torch.int32, device=cuda)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    o = kernels.flash_attention_fwd(q, k, v, kv, True, d ** -0.5, lse=lse)
    got = kernels.flash_attention_bwd(q, k, v, o, w, lse, kv, True, d ** -0.5)
    want = kernels.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, o, w)), lse, kv, True, d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert all(t.transpose(1, 2).is_contiguous() for t in got)


def test_backward_kernel_refuses(cuda):
    """head_dim 48, mixed dtypes and a misaligned view are refused with a
    ValueError before any launch."""
    q, k, v, w, kv, o, lse = _bwd_inputs(cuda, torch.bfloat16, 2, 4, 2, 128, 64, None, False)
    before = dict(kernels.launches)
    q48 = torch.zeros((2, 4, 128, 48), dtype=torch.bfloat16, device=cuda)
    k48 = torch.zeros((2, 2, 128, 48), dtype=torch.bfloat16, device=cuda)
    lse48 = torch.zeros((2, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kernels.flash_attention_bwd(q48, k48, k48, q48, q48, lse48, None, False, 0.125)
    with pytest.raises(ValueError, match="dtypes"):
        kernels.flash_attention_bwd(q, k.float(), v, o, w, lse, None, False, 0.125)
    with pytest.raises(ValueError, match="must match q"):
        kernels.flash_attention_bwd(q, k, v, o, w.float(), lse, None, False, 0.125)
    wide = torch.zeros((2, 4, 128, 65), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        kernels.flash_attention_bwd(q, k, v, o, wide[..., 1:], lse, None, False, 0.125)
    with pytest.raises(ValueError, match="lse"):
        kernels.flash_attention_bwd(q, k, v, o, w, lse.half(), None, False, 0.125)
    assert kernels.launches == before


def test_train_answer_two_steps_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """The train_answer command line in-process on the card: the shipped
    ocr_bpe warm-started, an extraction step then an answer step at batch 2.
    Each step launches K1 12 times (2 global + 4 decoder blocks, forward and
    remat recompute; the 64-token windows take the plain path) and its
    backward kernel 6 times; both losses are finite and the checkpoint
    loads."""
    import re

    from vision_compression_project_tpu_torch import config
    from vision_compression_project_tpu_torch.scripts import train_answer
    from vision_compression_project_tpu_torch.train import checkpoint

    monkeypatch.setattr(config, "RUNTIME", dataclasses.replace(config.RUNTIME, device="cuda"))
    kernels.reset_launch_counts()
    train_answer.main(["--preset", "ocr_bpe", "--steps", "2", "--batch", "2", "--log_every", "1",
                       "--init_from", config.shipped_checkpoint_dir("ocr_bpe"), "--ckpt_dir", str(tmp_path / "ck")])
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == 24 and kernels.launches["flash_attention_bwd"] == 12
    lines = capsys.readouterr().out.splitlines()
    step2 = [line for line in lines if line.startswith("step     2")]
    assert len(step2) == 1
    extract, answer = (float(x) for x in re.findall(r"(?:extract|answer) (\S+)", step2[0]))
    assert np.isfinite(extract) and np.isfinite(answer)
    runner = checkpoint.load_runner(get_preset("ocr_bpe"), tmp_path / "ck", device="cuda")
    reply = runner.answer("What about the audit?", "[Page 1 | memory_id=m01]\nThe audit team met.", max_new=8)
    assert isinstance(reply, str)


# The multi-device layer on the card: the ring's per-rank steps for virtual
# ranks (ops/ring_attention.py) and the sharded search's per-shard step and
# merge (parallel/collectives.py), at small sizes; one NCCL rank through the
# launcher. chip_smoke.py's [parallel] phase runs the same at full width.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (2, 6, 2, 256, 64, [256, 100], True),
        (2, 4, 4, 128, 32, None, False),
        (1, 16, 4, 320, 128, [258], True),
        (2, 6, 6, 256, 64, [256, 3], False),
    ],
)
def test_ring_virtual_ranks_match_one_kernel_call(cuda, dtype, n, b, h, hkv, s, d, kv_len, causal):
    """n virtual ranks' hops, each one K1 launch with its log-sum-exp, merged
    in f32: within TOL of the plain mha_reference on the same inputs and of
    one K1 call over the whole sequence, with exactly n(n+1)/2 launches
    under causal and n*n without."""
    from vision_compression_project_tpu_torch.ops.ring_attention import ring_attention_virtual

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, heads, s, d), generator=g, device=cuda).to(dtype) for heads in (h, hkv, hkv))
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = ring_attention_virtual(q, k, v, n, causal=causal, kv_len=kv)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == (n * (n + 1) // 2 if causal else n * n)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    for want in (mha_reference(q, k, v, kv_len=kv, causal=causal), flash_attention(q, k, v, kv_len=kv, causal=causal)):
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_hops_match_plain(cuda, dtype):
    """Each hop of 4 virtual ranks at ocr_real's decoder-prefill shape (a
    272-row chunk against a chunk, the clamped kv_len reaching 0 on a row):
    ring_step's output and log-sum-exp against mha_reference and
    attention_lse on the same chunks, within TOL and 1e-5 (f32) / 1e-4
    (bf16) of the largest |lse|, +inf exactly on the rows without keys."""
    from vision_compression_project_tpu_torch.ops.ring_attention import ring_step

    n, chunk = 4, 272
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((4, heads, n * chunk, 64), generator=g, device=cuda).to(dtype) for heads in (6, 2, 2))
    kv_len = torch.tensor([1026, 1087, 700, 1088], dtype=torch.int32, device=cuda)
    qc, kc, vc = q.chunk(n, 2), k.chunk(n, 2), v.chunk(n, 2)
    tol_lse = 1e-4 if dtype == torch.bfloat16 else 1e-5
    empty = 0
    for idx in range(n):
        for src in range(idx + 1):
            hop_len = (kv_len - src * chunk).clamp(0, chunk).to(torch.int32)
            args = (qc[idx], kc[src], vc[src])
            out, lse = ring_step(*args, hop_len, src == idx, 64 ** -0.5)
            want = mha_reference(*args, kv_len=hop_len, causal=src == idx)
            want_lse = attention_lse(*args, kv_len=hop_len, causal=src == idx)
            assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
            inf = torch.isinf(want_lse)
            empty += int(inf.sum())
            assert torch.equal(torch.isposinf(lse), inf)
            if bool((~inf).any()):
                assert (lse[~inf] - want_lse[~inf]).abs().max().item() <= tol_lse * want_lse[~inf].abs().max().item()
    assert empty > 0


def _search_index(device):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((4000, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[[7, 1500, 3999]] = rows[2]  # ties across shards
    index = VectorIndex(64, capacity=4096, device=device)
    index.add(rows, [{"doc_id": f"d{i % 3}", "page": i} for i in range(4000)],
              memory_ids=[f"m{i:04d}" for i in range(4000)])
    return index, rows[[2, 10, 20, 30]]


def test_sharded_search_virtual_shards_equal_search(cuda):
    """4 virtual shards' local step (one K2 launch each) and merge give
    search's ids and scores to the last bit, ties included; each shard's
    K2 scores within SIM_ATOL of the plain version, masked ones exact."""
    from vision_compression_project_tpu_torch.parallel.collectives import local_topk, merge_topk

    index, queries = _search_index(cuda)
    q = torch.from_numpy(queries).to(cuda)
    per = index.capacity // 4
    for doc in (None, "d1"):
        mask = index._mask_for(doc)
        kernels.reset_launch_counts()
        parts = [local_topk(index._rows[i * per:(i + 1) * per], mask[i * per:(i + 1) * per], q, 6, i)
                 for i in range(4)]
        vals, idx = merge_topk(torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1), 6)
        got = index._results_from(vals.cpu().numpy(), idx.cpu().numpy())
        assert kernels.launches["masked_similarity"] == 4
        want = index.search(queries, top_k=6, doc_id=doc)
        assert [[(r["id"], r["score"]) for r in res] for res in got] == \
            [[(r["id"], r["score"]) for r in res] for res in want]
        for i in range(4):
            rows, m = index._rows[i * per:(i + 1) * per], mask[i * per:(i + 1) * per]
            scores, plain = masked_similarity(rows, q, m), masked_similarity_reference(rows, q, m)
            off = m <= 0
            assert bool((scores[:, off] == NEG_INF).all())
            assert (scores[:, ~off] - plain[:, ~off]).abs().max().item() <= SIM_ATOL


def _nccl_rank_search():
    from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh

    index, queries = _search_index("cuda")
    mesh = build_mesh(MeshConfig(data=1), "cuda")
    kernels.reset_launch_counts()
    got = index.search_sharded(mesh, queries, top_k=6, doc_id="d1")
    return (torch.distributed.get_backend(), kernels.launches["masked_similarity"],
            [[(r["id"], r["score"]) for r in res] for res in got],
            [[(r["id"], r["score"]) for r in res] for res in index.search(queries, top_k=6, doc_id="d1")])


def test_search_sharded_on_one_nccl_rank(cuda):
    """search_sharded in a one-rank NCCL group started by the launcher: one
    K2 launch, search's results to the last bit."""
    from vision_compression_project_tpu_torch.parallel import spawn

    ((backend, launches, got, want),) = spawn(_nccl_rank_search, 1, device_type="cuda", timeout_s=300)
    assert backend == "nccl" and launches == 1 and got == want


def _four_rank_parallel(device_type):
    """On each of 4 ranks: ring attention over a seq = 4 mesh at ocr_real's
    decoder-prefill shape against one whole-sequence call; search_sharded
    over a data = 4 mesh against search; a decoder's forward under a
    data = 2, seq = 2 mesh against the whole batch's. Inputs are made on
    the CPU from seeds, the same on every rank."""
    from vision_compression_project_tpu_torch.models import configs as tconfigs
    from vision_compression_project_tpu_torch.models.decoder import Decoder
    from vision_compression_project_tpu_torch.ops.ring_attention import ring_attention
    from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh, use_mesh
    from vision_compression_project_tpu_torch.parallel.sharding import gather_shards, local_shard

    dev = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    out = {"rank": torch.distributed.get_rank()}
    g = torch.Generator().manual_seed(11)
    b, h, hkv, s, d = 4, 6, 2, 1088, 64
    q, k, v = (torch.randn((b, heads, s, d), generator=g).to(dev, torch.bfloat16) for heads in (h, hkv, hkv))
    kv_len = torch.tensor([1026, 1087, 700, 1088], dtype=torch.int32, device=dev)
    mesh = build_mesh(MeshConfig(data=1, seq=4), device_type)
    axes = (None, None, "seq", None)
    kernels.reset_launch_counts()
    mine = ring_attention(mesh, *(local_shard(t, mesh, axes) for t in (q, k, v)), causal=True, kv_len=kv_len)
    out["ring_launches"] = kernels.launches["flash_attention"]
    got = gather_shards(mine, mesh, axes)
    want = flash_attention(q, k, v, kv_len=kv_len, causal=True)
    out["ring_err"] = (got.float() - want.float()).abs().max().item()
    plain = mha_reference(q, k, v, kv_len=kv_len, causal=True)
    out["ring_plain_err"] = (got.float() - plain.float()).abs().max().item()
    index, queries = _search_index(dev)
    kernels.reset_launch_counts()
    sharded = index.search_sharded(build_mesh(MeshConfig(data=4), device_type), queries, top_k=6, doc_id="d1")
    out["search_launches"] = kernels.launches["masked_similarity"]
    out["search_equal"] = [[(r["id"], r["score"]) for r in res] for res in sharded] == \
        [[(r["id"], r["score"]) for r in res] for res in index.search(queries, top_k=6, doc_id="d1")]
    torch.manual_seed(3)
    cfg = tconfigs.DecoderConfig(vocab=64, dim=256, depth=2, heads=4, kv_heads=2, head_dim=64, max_seq=512)
    model = Decoder(cfg).to(dev).eval()
    x = (torch.randn((4, 256, cfg.dim), generator=g) * 0.3).to(dev, torch.bfloat16)
    sp = build_mesh(MeshConfig(data=2, seq=2), device_type)
    with torch.no_grad():
        with use_mesh(sp):
            logits = model(local_shard(x, sp, ("batch", "seq", "embed")))
        whole = model(x)
    got = gather_shards(logits, sp, ("batch", "seq", "vocab"))
    out["sp_err"] = ((got - whole).abs() - 0.05 * whole.abs()).max().item()
    return out


def test_four_nccl_ranks_ring_search_and_sp_decoder(cuda):
    """World size 4 over NCCL, one card a rank: the ring within the bf16
    limit of mha_reference and of one K1 call (rank i launches K1 i + 1
    times under causal),
    search_sharded equal to search with one K2 launch a rank, and the SP
    decoder within tests/test_sp_forward.py's bf16 limits of the whole
    forward."""
    from vision_compression_project_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    for name in ("flash_attention", "masked_similarity"):
        kernels.build(name)  # once, before the ranks load it
    outs = spawn(_four_rank_parallel, 4, "cuda", device_type="cuda", timeout_s=600)
    for i, o in enumerate(outs):
        assert o["rank"] == i and o["ring_launches"] == i + 1
        assert o["ring_err"] <= TOL[torch.bfloat16] and o["ring_plain_err"] <= TOL[torch.bfloat16]
        assert o["search_equal"] and o["search_launches"] == 1
        assert o["sp_err"] <= 0.08


# Sharded training on the card: the ring's backward for virtual ranks (each
# reverse hop one launch of K1's backward), the sharded train step on a
# one-rank NCCL mesh, one prod MoE block as model 2 x expert 2 virtual
# ranks, and on 4 cards the sharded steps against one card's.
# chip_smoke.py's [sharded_train] phase runs the first three at full width.
GRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _rel_err(got, want):
    want = want.float()
    return (got.float() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (4, 6, 2, 1088, 64, [1026, 1087, 0, 1088], True),   # ocr_real's decoder prefill, a row without keys
        (2, 16, 4, 320, 128, [258, 320], True),           # prod's decoder prefill: 80-row hops at 4 ranks
        (2, 6, 6, 1024, 64, None, False),                 # ocr_real's global encoder call
    ],
)
def test_ring_backward_matches_whole_and_plain(cuda, dtype, n, b, h, hkv, s, d, kv_len, causal):
    """The gradient of n virtual ranks' ring: exactly n(n+1)/2 (causal) or
    n*n launches of K1's backward, dq/dk/dv within GRAD_RTOL of K1's
    whole-sequence backward and of autograd through mha_reference in f32,
    zero on a row without keys."""
    from vision_compression_project_tpu_torch.ops.ring_attention import ring_attention_virtual

    g = torch.Generator(device=cuda).manual_seed(9)
    inputs = [torch.randn((b, heads, s, d), generator=g, device=cuda).to(dtype) for heads in (h, hkv, hkv)]
    grad = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    leaves = [t.clone().requires_grad_() for t in inputs]
    kernels.reset_launch_counts()
    ring_attention_virtual(*leaves, n, causal=causal, kv_len=kv).backward(grad)
    torch.cuda.synchronize()
    want_hops = n * (n + 1) // 2 if causal else n * n
    assert kernels.launches["flash_attention_bwd"] == want_hops and kernels.launches["flash_attention"] == want_hops
    whole = [t.clone().requires_grad_() for t in inputs]
    flash_attention(*whole, kv_len=kv, causal=causal).backward(grad)
    plain = [t.float().requires_grad_() for t in inputs]
    mha_reference(*plain, kv_len=kv, causal=causal).backward(grad.float())
    for got, a, p in zip(leaves, whole, plain):
        assert bool(torch.isfinite(got.grad).all())
        assert _rel_err(got.grad, a.grad) <= GRAD_RTOL[dtype]
        assert _rel_err(got.grad, p.grad) <= GRAD_RTOL[dtype]
        for i in [i for i, n_keys in enumerate(kv_len or []) if n_keys == 0]:
            assert bool((got.grad[i] == 0).all())


def _nccl_rank_mesh_of_one():
    """ocr_real at full width, 2 steps on a random batch of 2 rows, without a
    mesh and on a mesh of 1: (losses, params equal, launches)."""
    from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh
    from vision_compression_project_tpu_torch.train.train_step import make_train_state, train_step

    torch.backends.cudnn.deterministic = True
    cfg = get_preset("ocr_real")
    g = torch.Generator().manual_seed(4)
    v = cfg.vision
    batch = {"patch_tokens": torch.randn((2, v.grid * v.grid, v.patch * v.patch * 3), generator=g)
             .to("cuda", torch.bfloat16),
             "token_ids": torch.randint(3, 4000, (2, 129), generator=g).to("cuda")}
    runs = []
    for mesh in (None, build_mesh(MeshConfig(1, 1, 1, 1), "cuda")):
        model, opt, state = make_train_state(cfg, "cuda", seed=1, lr=1e-4, mesh=mesh)
        kernels.reset_launch_counts()
        losses = [float(train_step(model, opt, state, batch, mesh=mesh)[1]) for _ in range(2)]
        runs.append((losses, {k: p.detach().clone() for k, p in state.params.items()}, dict(kernels.launches)))
    (l0, p0, n0), (l1, p1, n1) = runs
    return l0 == l1, all(torch.equal(p0[k], p1[k]) for k in p0), n0 == n1, n1


def test_sharded_step_on_a_mesh_of_one_nccl_rank(cuda):
    """make_train_state/train_step on a one-rank NCCL mesh: the unsharded
    step's losses and parameters to the bit, the same K1 launches."""
    from vision_compression_project_tpu_torch.parallel import spawn

    ((losses_equal, params_equal, launches_equal, launches),) = spawn(
        _nccl_rank_mesh_of_one, 1, device_type="cuda", timeout_s=600)
    assert losses_equal and params_equal and launches_equal
    assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0


def test_tp_ep_prod_block_virtual_ranks(cuda):
    """chip_smoke's (c): one prod MoE decoder block as model 2 x expert 2
    virtual ranks, one K1 launch forward and backward a rank, within
    GRAD_RTOL of the whole block (chip_smoke.fail exits on a mismatch)."""
    import chip_smoke

    rec = chip_smoke.tp_ep_block_phase(get_preset("prod"), 0)
    assert rec["launches"] == {"flash_attention": 4, "flash_attention_bwd": 4}
    assert rec["max_rel_err"] <= GRAD_RTOL[torch.bfloat16]


FOUR_CARD_STEPS = 2


def _four_card_batch(cfg, text_len, rows, seed):
    from vision_compression_project_tpu_torch.train.data import device_batch, synthetic_batches

    mixc = dict(kind="real", jumble_frac=0.5, font_size=24, lines=14, dpi=93)
    return {k: v.cpu() for k, v in device_batch(cfg, next(synthetic_batches(
        cfg, rows, text_len=text_len, seed=seed, **mixc)), device="cpu").items()}


def _prod_train_cfg():
    cfg = get_preset("prod")
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, depth_local=2, depth_global=2),
                               decoder=dataclasses.replace(cfg.decoder, depth=4))


def _four_card_steps(name, mesh_shape, batch):
    """FOUR_CARD_STEPS sharded steps of `name` on a mesh (None: one card)."""
    from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh
    from vision_compression_project_tpu_torch.parallel.sharding import shard_batch
    from vision_compression_project_tpu_torch.train.train_step import make_train_state, train_step

    cfg = _prod_train_cfg() if name == "prod_train" else get_preset("ocr_real")
    mesh = None if mesh_shape is None else build_mesh(MeshConfig(*mesh_shape), "cuda")
    model, opt, state = make_train_state(cfg, "cuda", seed=0, lr=1e-4, mesh=mesh)
    batch = {k: v.to("cuda") for k, v in batch.items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    kernels.reset_launch_counts()
    losses = [float(train_step(model, opt, state, batch, mesh=mesh)[1]) for _ in range(FOUR_CARD_STEPS)]
    return losses, dict(kernels.launches)


def test_four_card_sharded_steps_match_one_card(cuda):
    """World size 4 over NCCL, one card a rank: prod_train's depth cut (2 +
    2 vision, 4 decoder blocks, full width) at expert 2 x model 2, and
    ocr_real at mixC with text_len 513 (1,536 positions, 384 a rank) at
    seq 4, FOUR_CARD_STEPS steps each on a batch of 4 pages: the losses of
    every rank equal, and within 2e-2 x max(loss, 1) of one card's (bf16
    activations summed over ranks in another order)."""
    from vision_compression_project_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    for name in ("flash_attention", "flash_attention_bwd", "adamw"):
        kernels.build(name)  # once, before the ranks load it
    cases = {"prod_train": ((1, 1, 2, 2), _prod_train_cfg(), 511), "ocr_real": ((1, 4, 1, 1), get_preset("ocr_real"), 513)}
    for name, (shape, cfg, text_len) in cases.items():
        batch = _four_card_batch(cfg, text_len, 4, 0)
        want, _ = _four_card_steps(name, None, batch)
        torch.cuda.empty_cache()
        outs = spawn(_four_card_steps, 4, name, shape, batch, device_type="cuda", timeout_s=900)
        for losses, launches in outs:
            assert losses == outs[0][0]
            assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0
            for got, w in zip(losses, want):
                assert abs(got - w) <= 2e-2 * max(abs(w), 1.0), (name, losses, want)


def test_pp_ocr_real_step_card_equals_cpu(cuda):
    """One pipelined ocr_real step (make_pp_vlm_train_step, 2 microbatches
    through 2 virtual stages) at batch 2 in f32, the same seeded weights and
    batch on the card and on the CPU, with the limits of
    test_ocr_real_train_step_card_equals_cpu. The step launches K1 28 times
    (8 encoder blocks, forward and remat recompute, and 6 decoder blocks once
    a microbatch, no recompute inside the pipeline) and its backward kernel
    20 times (8 + 6 x 2)."""
    from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID
    from vision_compression_project_tpu_torch.train.pp_train import make_pp_train_state, make_pp_vlm_train_step

    cfg = get_preset("ocr_real")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                              decoder=dataclasses.replace(cfg.decoder, dtype="float32"))
    rng = np.random.default_rng(0)
    v = cfg.vision
    patches = torch.tensor(rng.standard_normal((2, v.grid * v.grid, v.patch * v.patch * 3)), dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, cfg.decoder.vocab, size=(2, 511)))
    ids[:, 0] = BOS_ID
    lr = 1e-5
    results = {}
    for device in ("cpu", cuda):
        model, opt, state = make_pp_train_state(cfg, device=device, seed=0, lr=lr)
        step, rows = make_pp_vlm_train_step(model, opt, None, n_micro=2, virtual_stages=2)
        kernels.reset_launch_counts()
        state, loss = step(state, rows({"patch_tokens": patches.to(device), "token_ids": ids.to(device)}))
        results[str(device)] = (float(loss), {k: p.grad.float().cpu() for k, p in state.params.items()},
                                {k: p.detach().cpu() for k, p in state.params.items()},
                                (kernels.launches["flash_attention"], kernels.launches["flash_attention_bwd"]))
    (cpu_loss, cpu_grads, cpu_params, _), (loss, grads, params, launches) = results["cpu"], results["cuda"]
    assert launches == (28, 20)
    assert abs(loss - cpu_loss) <= 1e-4
    for name, want in cpu_grads.items():
        got = grads[name]
        assert bool(torch.isfinite(got).all()), name
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item() + 1e-6, name
        assert (params[name] - cpu_params[name]).abs().max().item() <= 2 * lr, name


PP_CARD_MICROBATCHES = 2


def _pp_card_steps(mesh_shape, batch):
    """FOUR_CARD_STEPS pipelined ocr_real steps on a mesh (None: one card)."""
    from vision_compression_project_tpu_torch.parallel import MeshConfig, build_mesh
    from vision_compression_project_tpu_torch.train.pp_train import make_pp_train_state, make_pp_vlm_train_step

    cfg = get_preset("ocr_real")
    mesh = None if mesh_shape is None else build_mesh(MeshConfig(*mesh_shape), "cuda")
    model, opt, state = make_pp_train_state(cfg, "cuda", seed=0, lr=1e-4, mesh=mesh)
    step, rows = make_pp_vlm_train_step(model, opt, mesh, n_micro=PP_CARD_MICROBATCHES)
    local = rows({k: v.to("cuda") for k, v in batch.items()})
    kernels.reset_launch_counts()
    losses = [float(step(state, local)[1]) for _ in range(FOUR_CARD_STEPS)]
    return losses, dict(kernels.launches)


def _pp_cards_match_one_card(n, mesh_shape):
    """World size n over NCCL: ocr_real's pipelined step on `mesh_shape`,
    FOUR_CARD_STEPS steps on a mixC batch of 4 pages with 2 microbatches:
    every rank's losses equal, within 2e-2 x max(loss, 1) of one card's
    (bf16, the clip's norm summed in another order), and each rank
    launching K1 and its backward."""
    from vision_compression_project_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    for name in ("flash_attention", "flash_attention_bwd", "adamw"):
        kernels.build(name)  # once, before the ranks load it
    batch = _four_card_batch(get_preset("ocr_real"), 511, 4, 0)
    want, _ = _pp_card_steps(None, batch)
    torch.cuda.empty_cache()
    outs = spawn(_pp_card_steps, n, mesh_shape, batch, device_type="cuda", timeout_s=900)
    for losses, launches in outs:
        assert losses == outs[0][0]
        assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0
        for got, w in zip(losses, want):
            assert abs(got - w) <= 2e-2 * max(abs(w), 1.0), (losses, want)


def test_pp_two_cards_match_one_card(cuda):
    """Two stages on two cards (model 2, 3 decoder blocks a stage): the
    activations and their gradients cross between cards by NCCL send/recv."""
    _pp_cards_match_one_card(2, (1, 1, 1, 2))


def test_pp_four_cards_match_one_card(cuda):
    """Data 2 x model 2 on four cards: two pipelines of two stages, each
    gradient also summed over `data`."""
    _pp_cards_match_one_card(4, (2, 1, 1, 2))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_over_nccl(cuda, n, capsys):
    from vision_compression_project_tpu_torch.dryrun import dryrun_multichip

    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    for name in ("flash_attention", "flash_attention_bwd"):
        kernels.build(name)
    lines = dryrun_multichip(n, "cuda")
    assert lines[-1].startswith(f"dryrun_multichip OK: n={n} meshes=2 ") and "pipeline(model)" in lines[-1]


# The gated short conv's kernels (kernels/short_conv.cu) against ShortConv's
# plain path on the card: LFM2's cell, (32, 766, 2048) with 3 taps in bf16,
# and small shapes: rows of 1, 2, 3 and 5 positions, batches 1-3, widths 16
# and 2048, 2-4 taps, bf16 and f32; a row past the kernel's run of 32
# positions, and widths the 16-byte vectors do not fill (one element a
# thread).
SHORT_CONV_CASES = [(32, 766, 2048, 3, torch.bfloat16)] + [
    (b, s, dim, k, dtype) for dtype in (torch.bfloat16, torch.float32) for k in kernels.SHORT_CONV_TAPS
    for b, s, dim in ((1, 1, 16), (2, 2, 2048), (3, 3, 16), (2, 5, 2048), (3, 5, 16), (2, 70, 12))
]


def _short_conv_inputs(cuda, b, s, dim, k, dtype):
    """A ShortConv with identity projections (its plain path from h to the
    gated product), h and dout, seeded."""
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + s * 10 + k)
    conv = layers.ShortConv(dim, k, dtype=str(dtype).split(".")[-1]).to(cuda)
    conv.in_proj, conv.out_proj = torch.nn.Identity(), torch.nn.Identity()
    with torch.no_grad():
        conv.taps.copy_(torch.randn(dim, k, generator=g, device=cuda))
    h = torch.randn(b, s, 3 * dim, generator=g, device=cuda).to(dtype).requires_grad_()
    dout = torch.randn(b, s, dim, generator=g, device=cuda).to(dtype)
    return conv, h, dout


def _short_conv_taps_f64(h, taps, dout):
    """The taps' gradient as an f64 sum of the f32 products dY(t) P(t-k+1+j)."""
    k, s, dim = taps.shape[1], h.shape[1], h.shape[2] // 3
    b, c, x = h.float().split(dim, dim=-1)
    pp = torch.nn.functional.pad((b * x).to(h.dtype).double(), (0, 0, k - 1, 0))
    dy = (dout.float() * c).double()
    return torch.stack([(dy * pp[:, j:j + s]).sum(dim=(0, 1)) for j in range(k)], dim=1)


@pytest.mark.parametrize("b,s,dim,k,dtype", SHORT_CONV_CASES)
def test_short_conv_forward_equals_plain(cuda, b, s, dim, k, dtype):
    """The kernel's forward bit-equal to the plain path, one launch."""
    conv, h, _ = _short_conv_inputs(cuda, b, s, dim, k, dtype)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = kernels.short_conv_fwd(h.detach(), conv.taps.detach())
        want = conv._plain(h)
    torch.cuda.synchronize()
    assert kernels.launches["short_conv"] == 1
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("b,s,dim,k,dtype", SHORT_CONV_CASES)
def test_short_conv_backward_equals_plain(cuda, b, s, dim, k, dtype):
    """Through `_ShortConvFn`: the forward and the gradient of h (dB, dC and
    dx') bit-equal to autograd of the plain path; the taps' gradient no
    further from an f64 sum of the same products than the plain path's,
    plus 1e-6 (relative L2); a second backward call gives the same bits."""
    conv, h, dout = _short_conv_inputs(cuda, b, s, dim, k, dtype)
    taps = conv.taps.detach().requires_grad_()
    want = conv._plain(h)
    dh_want, dtaps_want = torch.autograd.grad(want, (h, conv.taps), dout)
    kernels.reset_launch_counts()
    got = layers._ShortConvFn.apply(h, taps)
    dh, dtaps = torch.autograd.grad(got, (h, taps), dout)
    again = kernels.short_conv_bwd(h.detach(), taps.detach(), dout)
    torch.cuda.synchronize()
    assert (kernels.launches["short_conv"], kernels.launches["short_conv_bwd"]) == (1, 2)
    assert torch.equal(got, want)
    assert dh.dtype == dtype and dh.is_contiguous() and torch.equal(dh, dh_want)
    exact = _short_conv_taps_f64(h.detach(), taps.detach(), dout)

    def gap(t):
        return float((t.double() - exact).norm() / exact.norm())

    assert dtaps.dtype == torch.float32 and gap(dtaps) <= gap(dtaps_want) + 1e-6
    assert torch.equal(again[0].view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       dh.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(again[1].view(torch.int32), dtaps.view(torch.int32))


def test_short_conv_lfm2_step_launches(cuda):
    """A tiny LFM2 train_step in bf16 on the card: each conv block launches
    the forward twice (forward and remat recompute) and the backward once;
    the loss and every gradient are finite."""
    from vision_compression_project_tpu_torch.models.configs import DecoderConfig
    from vision_compression_project_tpu_torch.train.train_step import make_train_state, train_step

    layer_types = ["conv", "conv", "full_attention", "conv", "full_attention", "conv"]
    tiny = get_preset("tiny")
    cfg = dataclasses.replace(tiny, decoder=DecoderConfig(
        vocab=512, tokenizer="byte", dim=64, depth=6, heads=4, kv_heads=2, head_dim=16, mlp_ratio=2.0, max_seq=512,
        rope_theta=1e6, num_experts=8, expert_every=1, capacity_factor=1.25, dtype="bfloat16",
        layer_types=layer_types, num_dense_layers=2, moe_dim=32, router="sigmoid", experts_per_token=2,
        qk_norm=True, conv_kernel=3, norm_eps=1e-5))
    rng = np.random.default_rng(0)
    v = cfg.vision
    batch = {"patch_tokens": torch.tensor(rng.standard_normal((2, v.grid * v.grid, v.patch * v.patch * 3)),
                                          dtype=torch.float32, device=cuda),
             "token_ids": torch.tensor(rng.integers(0, cfg.decoder.vocab, size=(2, 40)), device=cuda)}
    batch["token_ids"][:, 0] = BOS_ID
    model, opt, state = make_train_state(cfg, device=cuda, seed=0, lr=1e-4)
    kernels.reset_launch_counts()
    state, loss = train_step(model, opt, state, batch)
    torch.cuda.synchronize()
    convs = layer_types.count("conv")
    assert (kernels.launches["short_conv"], kernels.launches["short_conv_bwd"]) == (2 * convs, convs)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(p.grad).all()) for p in state.params.values())


SHORT_CONV_REFUSED = {
    "h of 2 dimensions": lambda d: ((10, 48), torch.bfloat16, (16, 3), None, d, d),
    "h not 3 x dim wide": lambda d: ((2, 5, 47), torch.bfloat16, (16, 3), None, d, d),
    "h in float16": lambda d: ((2, 5, 48), torch.float16, (16, 3), None, d, d),
    "taps of another width": lambda d: ((2, 5, 48), torch.bfloat16, (15, 3), None, d, d),
    "one tap": lambda d: ((2, 5, 48), torch.bfloat16, (16, 1), None, d, d),
    "five taps": lambda d: ((2, 5, 48), torch.bfloat16, (16, 5), None, d, d),
    "dout of another shape": lambda d: ((2, 5, 48), torch.bfloat16, (16, 3), (2, 5, 15), d, d),
    "taps on the CPU": lambda d: ((2, 5, 48), torch.bfloat16, (16, 3), None, d, "cpu"),
    "dout on the CPU": lambda d: ((2, 5, 48), torch.bfloat16, (16, 3), (2, 5, 16), d, "cpu"),
    "h on the CPU": lambda d: ((2, 5, 48), torch.bfloat16, (16, 3), None, "cpu", d),
}


@pytest.mark.parametrize("case", list(SHORT_CONV_REFUSED))
def test_short_conv_wrapper_refuses(cuda, case):
    """Each refused input raises ValueError and launches nothing, as do
    taps in bf16 and h or taps not contiguous."""
    shape, dtype, taps_shape, dout_shape, h_dev, other_dev = SHORT_CONV_REFUSED[case](cuda)
    h = torch.zeros(shape, dtype=dtype, device=h_dev)
    taps = torch.zeros(taps_shape, device=other_dev if dout_shape is None else cuda)
    dout = None if dout_shape is None else torch.zeros(dout_shape, dtype=dtype, device=other_dev)
    good_h, good_taps = torch.zeros((2, 5, 48), dtype=torch.bfloat16, device=cuda), torch.zeros((16, 3), device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.short_conv_fwd(h, taps) if dout is None else kernels.short_conv_bwd(h, taps, dout)
    loose_taps = torch.zeros((3, 16), device=cuda).t()
    for bad in ((good_h, good_taps.bfloat16()), (good_h.transpose(0, 1), good_taps), (good_h, loose_taps)):
        with pytest.raises(ValueError):
            kernels.short_conv_fwd(*bad)
    assert kernels.launches == before
