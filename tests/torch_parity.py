"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the mini ocr_real configuration in both packages, and flax parameter trees
made with numpy, so no test pays for an eager flax init."""

import jax
import jax.numpy as jnp
import numpy as np
from flax.core import meta

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu.models import vlm as jvlm
from vision_compression_project_tpu_torch.models import configs as tconfigs

# ocr_real's structure: 4 windows of 8x8 patches, 2x downsample, GQA 6:2,
# real-text BPE vocab 4096; widths and depths cut to run in seconds.
MINI_VISION = dict(
    image_size=256, patch=16, dim_local=48, dim_global=96, depth_local=1,
    depth_global=1, heads_local=6, heads_global=6, window=8, downsample=2,
)
MINI_DECODER = dict(
    vocab=4096, tokenizer="bpe:bpe_merges_real.json", dim=96, depth=2, heads=6,
    kv_heads=2, head_dim=16, max_seq=512,
)


def mini_configs(dtype):
    """(JAX VLMConfig, port VLMConfig) of the mini ocr_real in `dtype`."""
    v = dict(MINI_VISION, dtype=dtype)
    d = dict(MINI_DECODER, dtype=dtype)
    jcfg = jconfigs.VLMConfig(vision=jconfigs.VisionConfig(**v), decoder=jconfigs.DecoderConfig(**d))
    tcfg = tconfigs.VLMConfig(vision=tconfigs.VisionConfig(**v), decoder=tconfigs.DecoderConfig(**d))
    return jcfg, tcfg


def param_shapes(jcfg):
    """The flax parameter tree of OpticalVLM(jcfg), as shapes only."""
    model = jvlm.OpticalVLM(jcfg)
    grid, patch = jcfg.vision.grid, jcfg.vision.patch
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, grid * grid, patch * patch * 3), jnp.bfloat16),
            jnp.zeros((1, 8), jnp.int32),
        )
    )["params"]
    return meta.unbox(shapes)


def numpy_params(jcfg, seed):
    """Random f32 flax params for OpticalVLM(jcfg) at the scales of its
    initializers (kernels ~ 1/sqrt(fan_in), embeddings 0.02), with norm
    scales and biases perturbed off their init so their mapping is tested."""
    rng = np.random.default_rng(seed)

    def make(path, s):
        name = path[-1].key
        if name == "kernel":
            parent = path[-2].key
            fan_in = s.shape[0] if parent in ("wq", "wk", "wv") else int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, param_shapes(jcfg))


# ocr_bpe's structure: windows of 8x8 patches, 2x downsample, GQA 8:4 at
# head_dim 32 in the full model, max_seq 1024 and the BPE vocab 4096;
# widths and depths cut to run in seconds. The one 64-token window takes the
# plain attention path, as ocr_bpe's windows do.
MINI_BPE_VISION = dict(
    image_size=128, patch=16, dim_local=32, dim_global=64, depth_local=1,
    depth_global=1, heads_local=4, heads_global=4, window=8, downsample=2,
)
MINI_BPE_DECODER = dict(
    vocab=4096, tokenizer="bpe", dim=64, depth=2, heads=4, kv_heads=2, head_dim=16,
    max_seq=1024,
)


def mini_bpe_configs(dtype):
    """(JAX VLMConfig, port VLMConfig) of the mini ocr_bpe in `dtype`."""
    v = dict(MINI_BPE_VISION, dtype=dtype)
    d = dict(MINI_BPE_DECODER, dtype=dtype)
    jcfg = jconfigs.VLMConfig(vision=jconfigs.VisionConfig(**v), decoder=jconfigs.DecoderConfig(**d))
    tcfg = tconfigs.VLMConfig(vision=tconfigs.VisionConfig(**v), decoder=tconfigs.DecoderConfig(**d))
    return jcfg, tcfg


_SUBJECTS = ("The cache module", "The billing service", "Plant delta", "The audit team",
             "The retrieval index", "The vision encoder", "Cluster theta", "The night shift")
_VERBS = ("stored", "reported", "processed", "rejected", "shipped", "reviewed")
_OBJECTS = ("invoices", "pages", "units", "defect reports", "requests", "samples")


def prose_pages(seed, n_pages, sentences=6):
    """Seeded synthetic prose, one string per page; every sentence carries
    its page and sentence numbers, so no sentence repeats."""
    rng = np.random.default_rng(seed)
    pages = []
    for p in range(1, n_pages + 1):
        out = []
        for s in range(1, sentences + 1):
            subj = _SUBJECTS[rng.integers(len(_SUBJECTS))]
            verb = _VERBS[rng.integers(len(_VERBS))]
            obj = _OBJECTS[rng.integers(len(_OBJECTS))]
            out.append(f"{subj} {verb} {int(rng.integers(2, 999))} {obj} in section {p}.{s}.")
        pages.append(" ".join(out))
    return pages


def jax_script(name):
    """The repository's scripts/<name>.py as a module, imported as its
    command line imports it (scripts/ on the path for its _bootstrap), under
    the name jax_<name>."""
    import importlib.util
    import sys
    from pathlib import Path

    scripts = Path(__file__).resolve().parents[1] / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", scripts / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(scripts))
