"""The port's checkpoints against orbax and libzstd: both shipped
checkpoints read bit for bit as orbax restores them, the committed digests
equal those of orbax's restore, damaged files raise, TrainState checkpoints
written by the JAX package load to the same params, and the zstd decoder
round-trips frames made by the system's libzstd (loaded here through ctypes;
the port never loads it). The save side: `params_to_jax` inverts
`params_from_jax`; the port's own step and params checkpoints restore the
state and load into a runner; partial saves are ignored.

Tolerance: none anywhere; every comparison is of exact bytes.
"""

import collections
import ctypes
import ctypes.util
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from vision_compression_project_tpu import config as jconfig
from vision_compression_project_tpu.train import checkpoint as jckpt
from vision_compression_project_tpu.train.train_step import TrainState, make_optimizer
from vision_compression_project_tpu_torch import native
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.train import checkpoint as tckpt
from vision_compression_project_tpu_torch.train.ocdbt import CheckpointError, OcdbtStore, read_checkpoint
from vision_compression_project_tpu_torch.weights import params_from_jax

from torch_parity import mini_configs, numpy_params

SHIPPED = ("ocr_bpe", "ocr_real")


def _orbax_restore(preset):
    path = jckpt.latest_params(jconfig.shipped_checkpoint_dir(preset))
    return ocp.StandardCheckpointer().restore(path)


@pytest.fixture(scope="module")
def orbax_trees():
    return {preset: _orbax_restore(preset) for preset in SHIPPED}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("preset", SHIPPED)
def test_shipped_tensors_bit_equal_to_orbax(preset, orbax_trees):
    got = _flat(tckpt.load_params(jconfig.shipped_checkpoint_dir(preset)))
    want = _flat(orbax_trees[preset])
    assert list(got) == list(want) and len(got) == {"ocr_bpe": 82, "ocr_real": 136}[preset]
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        assert got[name].tobytes() == arr.tobytes(), name


@pytest.mark.parametrize("preset", SHIPPED)
def test_digest_file_equals_orbax_restore(preset, orbax_trees):
    assert tckpt.shipped_digests()[preset] == tckpt.param_digests(orbax_trees[preset])


@pytest.mark.parametrize("preset", SHIPPED)
def test_store_keys_and_values_equal_tensorstore(preset):
    path = tckpt.latest_params(jconfig.shipped_checkpoint_dir(preset))
    ours = OcdbtStore(path)
    theirs = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    keys = sorted(k.decode() for k in theirs.list().result())
    assert ours.keys() == keys
    for key in keys[:: max(1, len(keys) // 24)]:
        assert ours.read(key) == bytes(theirs.read(key).result().value), key


def test_interior_btree_nodes_read_as_tensorstore_writes_them(tmp_path):
    """A store whose B-tree has interior nodes (tiny node limit), values both
    inline and in data files."""
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                             "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}).result()
    txn = ts.Transaction()
    want = {f"key/{k:04d}/v": bytes([k % 256]) * (k % 40) for k in range(200)}
    for key, value in want.items():
        store.with_transaction(txn).write(key, value).result()
    txn.commit_async().result()
    ours = OcdbtStore(tmp_path)
    assert ours.keys() == sorted(want)
    assert {k: ours.read(k) for k in want} == want


def _copy_shipped(tmp_path, preset="ocr_bpe"):
    src = tckpt.latest_params(jconfig.shipped_checkpoint_dir(preset))
    dst = tmp_path / src.name
    shutil.copytree(src, dst)
    return dst


def test_truncated_data_file_raises(tmp_path):
    ckpt = _copy_shipped(tmp_path)
    data = max((ckpt / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
    with open(data, "r+b") as f:
        f.truncate(data.stat().st_size // 2)
    with pytest.raises(CheckpointError, match="file has"):
        read_checkpoint(ckpt)


def test_flipped_byte_in_btree_node_raises(tmp_path):
    ckpt = _copy_shipped(tmp_path)
    (node,) = (ckpt / "d").iterdir()  # the root B-tree leaf
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    node.write_bytes(bytes(raw))
    with pytest.raises(CheckpointError, match="CRC-32C"):
        read_checkpoint(ckpt)


def test_complete_steps_ignores_partial_saves(tmp_path):
    for name in ("step_00000002", "step_00000010", "step_00000011.orbax-checkpoint-tmp-1712",
                 "params_00000001", "steps_00000003"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_00000020").write_text("a stray file")
    for prefix in ("step", "params"):
        got = [p.name for p in tckpt.complete_steps(tmp_path, prefix)]
        assert got == [p.name for p in jckpt.complete_steps(tmp_path, prefix)]
    assert [p.name for p in tckpt.complete_steps(tmp_path)] == ["step_00000002", "step_00000010"]
    assert tckpt.latest_checkpoint(tmp_path).name == "step_00000010"
    assert tckpt.complete_steps(tmp_path / "missing") == []


def test_train_state_checkpoint_loads_same_params(tmp_path):
    jcfg, tcfg = mini_configs("float32")
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg, seed=5))
    state = TrainState(params=params, opt_state=make_optimizer(3e-4).init(params),
                       step=jnp.asarray(7, jnp.int32))
    jckpt.save_checkpoint(tmp_path, state)
    got = tckpt.load_params(tmp_path)
    want = _flat(params)
    assert {k: v.tobytes() for k, v in _flat(got).items()} == {k: v.tobytes() for k, v in want.items()}
    runner = tckpt.load_runner(tcfg, tmp_path, device="cpu")
    state_dict = runner.model.state_dict()
    for name, value in params_from_jax(numpy_params(jcfg, seed=5)).items():
        assert torch_equal(state_dict[name], value), name


def torch_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def test_no_checkpoint_gives_seeded_runner(tmp_path):
    _, tcfg = mini_configs("float32")
    fresh = tckpt.load_runner(tcfg, tmp_path / "nothing", seed=4, device="cpu")
    seeded = tvlm.VLMRunner(tcfg, seed=4, device="cpu")
    assert fresh.max_new_default == 256
    for name, value in seeded.model.state_dict().items():
        assert torch_equal(fresh.model.state_dict()[name], value), name


# ---------------------------------------------------------------- save side


@pytest.mark.parametrize("which", ["vlm", "embedder"])
def test_params_to_jax_inverts_params_from_jax(which):
    from vision_compression_project_tpu.models import configs as jconfigs
    from vision_compression_project_tpu.models.embedder import NeuralEmbedderModule as JEmbedder
    from vision_compression_project_tpu_torch.models import configs as tconfigs
    from vision_compression_project_tpu_torch.weights import params_to_jax

    if which == "vlm":
        jcfg, tcfg = mini_configs("float32")
        tree = numpy_params(jcfg, seed=2)
    else:
        small = dict(dim=64, depth=2, heads=4, max_seq=256)
        tcfg = tconfigs.EmbedderConfig(**small)
        shapes = jax.eval_shape(lambda: JEmbedder(jconfigs.EmbedderConfig(**small)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32)))["params"]
        rng = np.random.default_rng(2)
        tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                      __import__("flax").core.meta.unbox(shapes))
    back = params_to_jax(params_from_jax(tree), tcfg)
    want, got = _flat(tree), _flat(back)
    assert list(sorted(got)) == list(sorted(want))
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        assert got[name].tobytes() == arr.tobytes(), name


def _port_state(tcfg, seed):
    from vision_compression_project_tpu_torch.train.train_step import make_train_state

    model, opt, state = make_train_state(tcfg, device="cpu", seed=seed)
    with torch.no_grad():
        for i, (mu, nu) in enumerate(zip(state.opt_state.mu.values(), state.opt_state.nu.values())):
            mu.fill_(0.01 * i)
            nu.fill_(0.02 * i)
    state.opt_state.count, state.step = 5, 7
    return model, state


def test_train_state_saves_and_restores_exactly(tmp_path):
    _, tcfg = mini_configs("float32")
    model, state = _port_state(tcfg, seed=1)
    path = tckpt.save_checkpoint(tmp_path, state)
    assert path == tmp_path.resolve() / "step_00000007" and (path / tckpt.PORT_FILE).is_file()
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000007"]  # no temporary left
    _, fresh = _port_state(tcfg, seed=2)
    fresh.opt_state.count, fresh.step = 0, 0
    assert tckpt.restore_checkpoint(tmp_path, fresh) is fresh
    assert (fresh.step, fresh.opt_state.count) == (7, 5)
    for got, want in ((fresh.params, state.params), (fresh.opt_state.mu, state.opt_state.mu),
                      (fresh.opt_state.nu, state.opt_state.nu)):
        for name, value in want.items():
            assert torch_equal(got[name].detach(), value.detach()), name
    # load_runner reads the port's TrainState checkpoint: the same weights.
    runner = tckpt.load_runner(tcfg, tmp_path, device="cpu")
    for name, value in model.state_dict().items():
        assert torch_equal(runner.model.state_dict()[name], value), name
    assert tckpt.restore_checkpoint(tmp_path / "missing", fresh) is None


def test_params_checkpoint_round_trips_the_shipped_weights(tmp_path):
    tree = tckpt.load_params(jconfig.shipped_checkpoint_dir("ocr_bpe"))
    path = tckpt.save_params(tmp_path, tree, step=3)
    assert path.name == "params_00000003"
    got, want = _flat(tckpt.load_params(tmp_path)), _flat(tree)
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes() for k in want)
    raw = torch.load(path / tckpt.PORT_FILE, weights_only=True)
    assert "decoder.block_0.attn.wq.kernel" in raw["params"]  # the reference's dotted names


def test_partial_port_saves_are_ignored(tmp_path):
    _, tcfg = mini_configs("float32")
    _, state = _port_state(tcfg, seed=3)
    tckpt.save_checkpoint(tmp_path, state, step=2)
    partial = tmp_path / ".step_00000009.tmp-4242"
    partial.mkdir()
    (partial / tckpt.PORT_FILE).write_bytes(b"half a checkpoint")
    (tmp_path / "step_00000010.orbax-checkpoint-tmp-1").mkdir()
    assert [p.name for p in tckpt.complete_steps(tmp_path)] == ["step_00000002"]
    assert tckpt.latest_checkpoint(tmp_path).name == "step_00000002"
    assert tckpt.load_params(tmp_path) is not None


def test_restore_refuses_an_orbax_train_state(tmp_path):
    jcfg, tcfg = mini_configs("float32")
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg, seed=5))
    jckpt.save_checkpoint(tmp_path, TrainState(params=params, opt_state=make_optimizer(3e-4).init(params),
                                               step=jnp.asarray(1, jnp.int32)))
    _, state = _port_state(tcfg, seed=3)
    with pytest.raises(ValueError, match="orbax"):
        tckpt.restore_checkpoint(tmp_path, state)


# ---------------------------------------------------------------- zstd

_ZSTD_C = {"level": 100, "content_size": 200, "checksum": 201}  # ZSTD_cParameter values


def _libzstd():
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


@pytest.fixture(scope="module")
def compress():
    lib = _libzstd()
    cache = {}

    def run(data: bytes, level: int, checksum: bool, content_size: bool) -> bytes:
        key = (hash(data), len(data), level, checksum, content_size)
        if key not in cache:
            cache[key] = make(data, level, checksum, content_size)
        return cache[key]

    def make(data, level, checksum, content_size):
        cctx = lib.ZSTD_createCCtx()
        try:
            for key, value in (("level", level), ("checksum", int(checksum)),
                               ("content_size", int(content_size))):
                assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_C[key], value))
            cap = lib.ZSTD_compressBound(len(data))
            out = ctypes.create_string_buffer(cap)
            n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
            assert not lib.ZSTD_isError(n)
            return out.raw[:n]
        finally:
            lib.ZSTD_freeCCtx(cctx)

    return run


def _corpus():
    """Inputs that make libzstd emit every block and section type the
    decoder handles (see test_frames_cover_every_block_and_section_type)."""
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8)) for _ in range(300)]
    text = b" ".join(words[k] for k in rng.integers(0, 300, 60000))
    weights = (rng.standard_normal(70000) * 0.05).astype(np.float32).tobytes()
    nibbles = rng.choice(16, 50000, p=np.array([8, 4, 2, 2] + [1] * 12) / 28).astype(np.uint8).tobytes()
    seed = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    cuts = [seed] + [seed[a : a + int(n)] + b"z" for a, n in zip(rng.integers(0, 1900, 6000),
                                                                 rng.integers(20, 90, 6000))]
    runs = b"".join(bytes([int(v)]) * int(n) for v, n in zip(rng.integers(0, 256, 3000),
                                                           rng.integers(5, 40, 3000)))
    return {
        "text": text,  # 4-stream Huffman literals, FSE sequences, several blocks
        "f32_weights": weights,  # what the checkpoints hold
        "random": rng.integers(0, 256, 300000, dtype=np.uint8).tobytes(),  # raw blocks
        "zeros": bytes(400000),  # RLE blocks
        "short": b"hello hello hello world",  # 1-stream literals
        "one_byte": b"a",
        "nibbles": nibbles,  # Huffman weights sent directly
        "repeats": b"".join(cuts),  # repeat-mode tables, treeless literals, repeat offsets
        "byte_runs": runs,  # every match at offset 1: an RLE offset table
        "mixed": text[:50000] + bytes(200000) + weights[:100000] + seed + text,
    }


CORPUS = _corpus()


def _frame_features(frame: bytes) -> collections.Counter:
    """What a frame's blocks use, read from their headers."""
    c = collections.Counter()
    fhd = frame[4]
    i = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
    i += ((1 if fhd & 0x20 else 0), 2, 4, 8)[fhd >> 6]
    c["checksum" if fhd & 4 else "no_checksum"] += 1
    c["content_size" if (fhd >> 6 or fhd & 0x20) else "no_content_size"] += 1
    while True:
        bh = int.from_bytes(frame[i : i + 3], "little")
        i += 3
        kind, size = (bh >> 1) & 3, bh >> 3
        c[("raw_block", "rle_block", "compressed_block")[kind]] += 1
        if kind == 2:
            b = frame[i : i + size]
            lt, sf = b[0] & 3, (b[0] >> 2) & 3
            c[("raw_literals", "rle_literals", "huffman_literals", "treeless_literals")[lt]] += 1
            if lt < 2:
                hl = (1, 2, 1, 3)[sf]
                regen = b[0] >> 3 if hl == 1 else (b[0] >> 4) + (b[1] << 4) + ((b[2] << 12) if hl == 3 else 0)
                off = hl + (regen if lt == 0 else 1)
            else:
                c["1_stream" if sf == 0 else "4_streams"] += 1
                hl, bits = (3, 3, 4, 5)[sf], (10, 10, 14, 18)[sf]
                off = hl + ((int.from_bytes(b[:hl], "little") >> (4 + bits)) & ((1 << bits) - 1))
                if lt == 2:
                    c["fse_weights" if b[hl] < 128 else "direct_weights"] += 1
            if b[off]:
                c["sequences"] += 1
                modes = b[off + (1 if b[off] < 128 else 2 if b[off] < 255 else 3)]
                for table, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                    c[f"{table}_" + ("predefined", "rle", "fse", "repeat")[(modes >> shift) & 3]] += 1
        i += 1 if kind == 1 else size
        if bh & 1:
            return c


CASES = [(name, level, checksum, content_size)
         for name in CORPUS for level in (1, 3, 19) for checksum, content_size in ((False, True), (True, False))]


@pytest.mark.parametrize("name,level,checksum,content_size", CASES)
def test_zstd_round_trips_libzstd_frames(compress, name, level, checksum, content_size):
    data = CORPUS[name]
    frame = compress(data, level, checksum, content_size)
    assert bytes(native.zstd_decompress(frame, len(data))) == data
    assert bytes(native.zstd_decompress(frame)) == data  # no size given: the buffer grows


def test_frames_cover_every_block_and_section_type(compress):
    seen = collections.Counter()
    for name, level, checksum, content_size in CASES:
        seen += _frame_features(compress(CORPUS[name], level, checksum, content_size))
    want = {"checksum", "no_checksum", "content_size", "no_content_size", "raw_block", "rle_block",
            "compressed_block", "raw_literals", "huffman_literals", "treeless_literals", "1_stream",
            "4_streams", "fse_weights", "direct_weights", "sequences"}
    want |= {f"{t}_{m}" for t in ("ll", "of", "ml") for m in ("predefined", "rle", "fse", "repeat")}
    assert want <= set(seen), sorted(want - set(seen))


def test_rle_literals_and_skippable_frames():
    # A single-segment frame, content size 20, one compressed block whose
    # literals are 20 RLE copies of "q" and which has no sequences; then a
    # skippable frame; then a raw-block frame.
    rle = bytes([0x28, 0xB5, 0x2F, 0xFD, 0x20, 20]) + (1 | (2 << 1) | (3 << 3)).to_bytes(3, "little")
    rle += bytes([(20 << 3) | 1, ord("q"), 0])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    raw = bytes([0x28, 0xB5, 0x2F, 0xFD, 0x20, 3]) + (1 | (3 << 3)).to_bytes(3, "little") + b"abc"
    assert bytes(native.zstd_decompress(rle + skip + raw)) == b"q" * 20 + b"abc"


def test_frames_back_to_back(compress):
    parts = [CORPUS["text"][:1000], CORPUS["zeros"][:5000], CORPUS["f32_weights"][:40000]]
    frames = b"".join(compress(p, lvl, True, False) for p, lvl in zip(parts, (1, 3, 19)))
    assert bytes(native.zstd_decompress(frames, sum(map(len, parts)))) == b"".join(parts)


@pytest.mark.parametrize("damage", ["checksum", "bitstream", "truncated", "size"])
def test_zstd_damage_raises(compress, damage):
    data = CORPUS["text"][:20000]
    frame = bytearray(compress(data, 3, True, True))
    size = len(data)
    if damage == "checksum":
        frame[-1] ^= 1
    elif damage == "bitstream":
        frame[len(frame) // 2] ^= 0x10
    elif damage == "truncated":
        frame = frame[: len(frame) - 7]
    else:
        size += 1
    with pytest.raises(native.ZstdError):
        native.zstd_decompress(bytes(frame), size)


def test_crc32c_known_value():
    assert native.crc32c(b"123456789") == 0xE3069283
