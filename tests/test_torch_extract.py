"""The port's /ingest from a PDF against the JAX package's: the PDF writer,
the C++ engine through its binding, the on-device glyph renderer and
extract_pdf_to_page_jsons with the text engine and with the VLM engine (a
mini ocr_real in f32, parameters carried across by `params_from_jax`) by
both of its routes, glyph transport and pixels.

Tolerance: none. PDFs, rasters, glyph primitives, rendered pages, PNG pixels,
page JSONs, manifests and combined markdown are all compared exactly (the
VLM engine's greedy tokens are exact in f32; see tests/test_torch_slice.py).
The JAX side runs its XLA attention (VCP_FORCE_XLA_ATTENTION=1).
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu.ops import glyph_render as jglyph
from vision_compression_project_tpu.pipeline import extract as jex
from vision_compression_project_tpu.raster import PdfDocument as JPdf
from vision_compression_project_tpu.raster import make_pdf as jmake_pdf
from vision_compression_project_tpu.raster.rasterizer import glyph_atlas as jatlas
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.ops import glyph_render as tglyph
from vision_compression_project_tpu_torch.pipeline import extract as tex
from vision_compression_project_tpu_torch.raster import PdfDocument as TPdf
from vision_compression_project_tpu_torch.raster import glyph_atlas as tatlas
from vision_compression_project_tpu_torch.raster import make_pdf as tmake_pdf
from vision_compression_project_tpu_torch.utils.metrics import MetricsRegistry
from vision_compression_project_tpu_torch.weights import params_from_jax

from torch_parity import mini_configs, numpy_params, prose_pages

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
MAX_NEW = 24
PAGES = [
    "Render Parity\nThe quick brown fox jumps over the lazy dog.\n0123456789 !@#$%^&*()",
    "Second Page\n\nAnother block of text to rasterize faithfully.\n- a bullet\n- another",
    "Third page (with parentheses) and a backslash \\ in it.",
]


@pytest.fixture(scope="module")
def pdf(tmp_path_factory):
    path = tmp_path_factory.mktemp("pdf") / "doc.pdf"
    tmake_pdf(PAGES, path)
    return path


@pytest.mark.parametrize("kw", [{}, {"compress": True, "font_size": 17},
                                {"fonts": ["builtin", DEJAVU], "page_fonts": [0, 1, 1]}],
                         ids=["plain", "flate", "embedded_ttf"])
def test_make_pdf_bytes_equal(tmp_path, kw):
    if "fonts" in kw and not __import__("os").path.exists(DEJAVU):
        pytest.fail(f"{DEJAVU} is missing")
    assert tmake_pdf(PAGES, tmp_path / "t.pdf", **kw).read_bytes() == \
        jmake_pdf(PAGES, tmp_path / "j.pdf", **kw).read_bytes()


def test_glyph_atlas_equal():
    np.testing.assert_array_equal(tatlas(), jatlas())


@pytest.mark.parametrize("dpi", [72, 93, 150])
def test_pdf_engine_equal(pdf, dpi):
    with TPdf(pdf) as t, JPdf(pdf) as j:
        assert t.page_count == j.page_count == len(PAGES)
        assert t.has_text_layer() == j.has_text_layer() is True
        for p in range(len(PAGES)):
            assert t.page_size_pts(p) == j.page_size_pts(p)
            assert t.extract_text(p) == j.extract_text(p)
            assert t.page_complexity(p) == j.page_complexity(p) == 0
            np.testing.assert_array_equal(t.render_page(p, dpi), j.render_page(p, dpi))
            for a, b in zip(t.page_primitives(p, dpi), j.page_primitives(p, dpi)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(t.render_batch(0, 2, dpi), j.render_batch(0, 2, dpi)):
            np.testing.assert_array_equal(a, b)


def _render_both(glyphs, n_glyphs, rects, n_rects, h, w, chunk):
    got = tglyph.render_pages_from_glyphs(*map(torch.from_numpy, (glyphs, n_glyphs, rects, n_rects)), h=h, w=w)
    want = jglyph.render_pages_from_glyphs(*map(jnp.asarray, (glyphs, n_glyphs, rects, n_rects)),
                                           h=h, w=w, chunk=chunk)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dpi", [72, 150])
def test_render_pages_from_glyphs_pixel_identical(tmp_path, dpi):
    """The shapes of tests/test_glyph_render.py at its dpi (72), and at 150,
    where the glyph scale 25/12 rounds differently through the reciprocal."""
    pdf = tmake_pdf(PAGES[:2], tmp_path / "d.pdf")
    with TPdf(pdf) as doc:
        prims = [doc.page_primitives(i, dpi=dpi) for i in range(2)]
        h, w = doc.render_page(0, dpi=dpi).shape[:2]
    got, want = _render_both(*tglyph.pack_primitives(prims), h, w, chunk=512)
    assert got.dtype == np.uint8 and got.shape == (2, h, w) and (got < 128).any()
    np.testing.assert_array_equal(got, want)


def test_render_empty_offcanvas_and_rects_pixel_identical():
    glyphs = np.zeros((2, 8, 4), np.float32)
    glyphs[1, :5] = [[65, -6.0, 10.0, 12.0], [66, 60.0, 4.0, 12.0], [67, 30.0, -20.0, 12.0],
                     [68, 30.0, 200.0, 12.0], [69, 20.5, 30.3, 17.2]]
    rects = np.zeros((2, 4, 5), np.float32)
    rects[1, :3] = [[5, 5, 40, 20, 128], [10, 0, 30, 50, 30], [1, 1, 2, 2, 0]]
    got, want = _render_both(glyphs, np.array([0, 5], np.int32), rects, np.array([0, 2], np.int32),
                             64, 64, chunk=256)
    assert (got[0] == 255).all() and set(np.unique(got[1])) == {0, 30, 128, 255}
    np.testing.assert_array_equal(got, want)


def test_pack_primitives_equal():
    rng = np.random.default_rng(1)
    prims = [(rng.random((n, 4), dtype=np.float32), rng.random((m, 5), dtype=np.float32))
             for n, m in ((3, 0), (2100, 70), (0, 2))]
    for a, b in zip(tglyph.pack_primitives(prims), jglyph.pack_primitives(prims)):
        np.testing.assert_array_equal(a, b)


def _same_tree(a, b, glob="page_*.json"):
    names = sorted(p.name for p in a.glob(glob))
    assert names == sorted(p.name for p in b.glob(glob)) and names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_text_engine_pages_manifest_and_markdown_equal(tmp_path):
    pdf = jmake_pdf(prose_pages(2, 5), tmp_path / "d.pdf", compress=True)
    kw = dict(dpi=100, start_page=2, batch_size=2)
    got = tex.extract_pdf_to_page_jsons(pdf, tmp_path / "t", **kw)
    want = jex.extract_pdf_to_page_jsons(pdf, tmp_path / "j", **kw)  # engine "auto": the text layer
    assert got == want and got["processed_pages"] == [2, 3, 4, 5]
    _same_tree(tmp_path / "t", tmp_path / "j")
    tm = tex.create_manifest(pdf, tmp_path / "tm.json", got, 100, 2, None, "text")
    jm = jex.create_manifest(pdf, tmp_path / "jm.json", want, 100, 2, None, "text")
    tm.pop("timestamp"), jm.pop("timestamp")  # the clock at the call, on both sides
    assert tm == jm and tm["end_page"] == 5
    for m, n in ((tex, "t"), (jex, "j")):
        m.create_combined_markdown(tmp_path / n, tmp_path / f"{n}.md")
    assert (tmp_path / "t.md").read_bytes() == (tmp_path / "j.md").read_bytes()


@pytest.fixture(scope="module")
def runners():
    jcfg, tcfg = mini_configs("float32")
    params = numpy_params(jcfg, seed=2)
    return (jvlm.VLMRunner(jcfg, params=params, max_new_default=MAX_NEW),
            tvlm.VLMRunner(tcfg, params=params_from_jax(params), max_new_default=MAX_NEW, device="cpu"))


@pytest.fixture(scope="module")
def vlm_pdf(tmp_path_factory):
    return jmake_pdf(prose_pages(8, 5, sentences=5), tmp_path_factory.mktemp("vlm") / "d.pdf", font_size=14)


@pytest.mark.parametrize("route", ["glyph", "pixel"])
def test_vlm_engine_identical(tmp_path, runners, vlm_pdf, route, monkeypatch):
    """Both routes against the JAX package's same route: 5 pages in chunks
    of 2, the last one padded and trimmed. The glyph route draws the pages
    on the device; the pixel route renders at the full dpi and saves PNGs."""
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    jr, tr = runners
    calls = []
    for name in ("extract_batch_async", "extract_batch_async_glyphs"):
        orig = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    kw = dict(dpi=90, engine="vlm", batch_size=2, save_images=route == "pixel")
    got = tex.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / "t", images_dir=tmp_path / "ti", runner=tr, **kw)
    want = jex.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / "j", images_dir=tmp_path / "ji", runner=jr, **kw)
    assert got == want and got["processed_pages"] == [1, 2, 3, 4, 5] and not got["failed_pages"]
    assert calls == ["extract_batch_async_glyphs" if route == "glyph" else "extract_batch_async"] * 3
    _same_tree(tmp_path / "t", tmp_path / "j")
    rec = json.loads((tmp_path / "t" / "page_005.json").read_text())
    assert set(rec) == {"page_number", "markdown", "entities", "summary"} and rec["page_number"] == 5
    pngs = sorted(p.name for p in (tmp_path / "ti").glob("*.png"))
    assert pngs == (["page_00%d.png" % i for i in range(1, 6)] if route == "pixel" else [])
    for name in pngs:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ti" / name)),
                                      np.asarray(Image.open(tmp_path / "ji" / name)))


def test_failed_chunk_recorded_then_resumed(tmp_path, runners, vlm_pdf, monkeypatch):
    jr, tr = runners
    monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")

    def broken(self, primitives, *a, **k):
        if 3 in k["page_numbers"]:
            raise RuntimeError("device lost")
        return type(self).extract_batch_async_glyphs(self, primitives, *a, **k)

    stats = {}
    for name, mod, runner in (("t", tex, tr), ("j", jex, jr)):
        monkeypatch.setattr(runner, "extract_batch_async_glyphs", broken.__get__(runner))
        stats[name] = mod.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / name, dpi=90, engine="vlm",
                                                    batch_size=2, runner=runner, save_images=False)
        monkeypatch.undo()
        monkeypatch.setenv("VCP_FORCE_XLA_ATTENTION", "1")
    assert stats["t"] == stats["j"]
    assert stats["t"]["processed_pages"] == [1, 2, 5]
    assert stats["t"]["failed_pages"] == [{"page": 3, "error": "device lost"}, {"page": 4, "error": "device lost"}]
    # The rerun reads only the failed pages, and ends where a clean run would.
    resumed = tex.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / "t", dpi=90, engine="vlm", batch_size=2,
                                            runner=tr, save_images=False)
    assert resumed == {"pages_total": 5, "processed_pages": [1, 2, 3, 4, 5], "failed_pages": []}
    jex.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / "j", dpi=90, engine="vlm", batch_size=2,
                                  runner=jr, save_images=False)
    _same_tree(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("route", ["glyph", "pixel"])
def test_extract_batch_timer_takes_the_decode(tmp_path, runners, vlm_pdf, route, monkeypatch):
    """The port's runner decodes inside extract_batch_async(_glyphs), so the
    "extract.batch" timer, which /metrics' pages_per_sec reads, must take the
    dispatch as well as the collect: 3 chunks, each held 0.2 s in its
    dispatch, give at least 0.6 s."""
    _, tr = runners
    name = "extract_batch_async_glyphs" if route == "glyph" else "extract_batch_async"
    orig = getattr(tr, name)

    def slow(*a, **k):
        time.sleep(0.2)
        return orig(*a, **k)

    monkeypatch.setattr(tr, name, slow)
    registry = MetricsRegistry()
    monkeypatch.setattr(tex, "METRICS", registry)
    tex.extract_pdf_to_page_jsons(vlm_pdf, tmp_path / "t", images_dir=tmp_path / "ti", dpi=90, engine="vlm",
                                  batch_size=2, runner=tr, save_images=route == "pixel")
    timer = registry.snapshot()["timers"]["extract.batch"]
    assert timer["count"] == 3 and timer["total"] >= 0.6


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)], ids=["gray", "rgb"])
def test_save_png_decodes_to_the_image(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    tex._save_png(img, tmp_path / "p.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), img)


def test_model_dpi_and_stack_rasters_equal(pdf):
    with TPdf(pdf) as doc:
        for size in (64, 256, 1024, 4096):
            assert tex._model_dpi(doc, [1, 2], 150, size) == jex._model_dpi(doc, [1, 2], 150, size)
    rng = np.random.default_rng(4)
    gray = {1: np.repeat(rng.integers(0, 256, (20, 16, 1), dtype=np.uint8), 3, 2),
            2: np.repeat(rng.integers(0, 256, (24, 12, 1), dtype=np.uint8), 3, 2)}
    color = {**gray, 3: rng.integers(0, 256, (20, 16, 3), dtype=np.uint8)}
    for rasters in (gray, color, {1: gray[1], 3: color[3]}):
        pages = sorted(rasters)
        np.testing.assert_array_equal(tex._stack_rasters(rasters, pages), jex._stack_rasters(rasters, pages))
