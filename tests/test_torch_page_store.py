"""The DCT page store of the PyTorch port (ops/dct.py, raster/page_store.py)
against the JAX package's, on the CPU.

Inputs: seeded random gray planes (noise puts many coefficients near a
rounding edge) and a page rendered by the port's PDF engine. Tolerances:
the quantized coefficients come from the same f32 products summed in
another order, so a coefficient whose quotient lies within rounding of .5
may round the other way. On the seeded planes below 29 of 147,456
coefficients differ, each by exactly 1 (measured once, fixed inputs): the
test allows at most that many. Decoding the same coefficients gives pixels
within 1 (one of 147,456 differs). Each package reads the pages the other
wrote, within the same limits.
"""

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch.ops import dct as tdct
from vision_compression_project_tpu_torch.raster import PdfDocument, make_pdf
from vision_compression_project_tpu_torch.raster.page_store import PageStore

MAX_COEFF_DIFFS = 29


def _planes():
    for seed in range(6):
        img = np.random.default_rng(seed).integers(0, 256, (2, 64, 96), dtype=np.uint8)
        for scale in (1.0, 0.5):
            yield img, scale


def _page(tmp_path):
    pdf = make_pdf(["Store Test\nThe quick brown fox jumps over the lazy dog." * 3], tmp_path / "d.pdf")
    with PdfDocument(pdf) as doc:
        return doc.render_page(0, dpi=72)


def test_dct_tables_equal_jax():
    from vision_compression_project_tpu.ops import dct as jdct

    np.testing.assert_array_equal(tdct.JPEG_LUMA_QTABLE, jdct.JPEG_LUMA_QTABLE)
    np.testing.assert_array_equal(tdct._dct_matrix(), jdct._dct_matrix())


def test_dct_encode_matches_jax():
    import jax.numpy as jnp

    from vision_compression_project_tpu.ops import dct as jdct

    total = differ = 0
    for img, scale in _planes():
        want = np.asarray(jdct.dct8x8_encode(jnp.asarray(img), scale))
        got = tdct.dct8x8_encode(torch.from_numpy(img), scale).numpy()
        assert got.dtype == np.int16 and got.shape == want.shape == (2, 8, 12, 8, 8)
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        total += got.size
        differ += int((got != want).sum())
    assert total == 147_456
    assert differ <= MAX_COEFF_DIFFS


def test_dct_decode_matches_jax():
    import jax.numpy as jnp

    from vision_compression_project_tpu.ops import dct as jdct

    for img, scale in _planes():
        coeffs = np.array(jdct.dct8x8_encode(jnp.asarray(img), scale))
        want = np.asarray(jdct.dct8x8_decode(jnp.asarray(coeffs), scale))
        got = tdct.dct8x8_decode(torch.from_numpy(coeffs), scale).numpy()
        assert got.dtype == np.uint8 and got.shape == img.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_page_store_roundtrip_quality_and_size(tmp_path):
    """tests/test_page_store.py's checks, on the port."""
    rgb = _page(tmp_path)
    store = PageStore(tmp_path / "store", device="cpu")
    path = store.put(1, rgb)
    back = store.get(1)
    assert back.shape == rgb.shape
    err = np.abs(back.astype(np.int32) - rgb.astype(np.int32)).mean()
    assert err < 8.0, err
    ink = rgb.min(axis=-1) < 100
    assert ink.any()
    assert back[ink].mean() < 150
    assert path.stat().st_size < rgb.nbytes / 6
    assert store.pages() == [1]
    assert store.stats() == {"pages": 1, "bytes": path.stat().st_size}


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_each_package_reads_the_others_pages(tmp_path, scale):
    from vision_compression_project_tpu.raster.page_store import PageStore as JPageStore

    rgb = _page(tmp_path)
    tstore = PageStore(tmp_path / "torch", quality_scale=scale, device="cpu")
    jstore = JPageStore(tmp_path / "jax", quality_scale=scale)
    tstore.put(3, rgb)
    jstore.put(3, rgb)
    with np.load(tstore._path(3)) as t, np.load(jstore._path(3)) as j:
        assert sorted(t.files) == sorted(j.files) == ["cb", "cr", "h", "q", "w", "y"]
        for key in t.files:
            assert t[key].dtype == j[key].dtype and t[key].shape == j[key].shape
            assert np.abs(t[key].astype(np.float64) - j[key]).max() <= 1
    # The port reads the JAX package's page and the JAX package the port's.
    for reader, writer in ((PageStore(tmp_path / "jax", device="cpu"), jstore), (JPageStore(tmp_path / "torch"), tstore)):
        got, want = reader.get(3), writer.get(3)
        assert got.shape == rgb.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_page_store_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="cuda"):
        PageStore("unused")
