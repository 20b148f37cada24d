"""`params_from_jax` against flax parameter trees: every tensor lands in the
port's module bit-exact, and ocr_real's state_dict has the shipped reader's
136 tensors and 29,305,152 parameters."""

import jax
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.models import configs as jconfigs
from vision_compression_project_tpu_torch.models import configs as tconfigs
from vision_compression_project_tpu_torch.models import vlm as tvlm
from vision_compression_project_tpu_torch.weights import params_from_jax

from torch_parity import mini_configs, numpy_params, param_shapes


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _back_to_flax(path, tensor):
    """The inverse layout map, written out independently of weights.py."""
    t = tensor.numpy()
    if path[-1] != "kernel":
        return t
    if t.ndim == 4:  # OIHW -> HWIO
        return t.transpose(2, 3, 1, 0)
    return t.T


def _torch_key(path):
    names = []
    for p in path[:-1]:
        for head, repl in (("local_", "local_blocks."), ("global_", "global_blocks."), ("block_", "blocks.")):
            if p.startswith(head) and p[len(head):].isdigit():
                p = repl + p[len(head):]
        names.append(p)
    leaf = {"kernel": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(names + [leaf])


@pytest.mark.parametrize("which", ["tiny", "mini_ocr_real"])
def test_params_round_trip_bit_exact(which):
    if which == "tiny":
        jcfg, tcfg = jconfigs.get_preset("tiny"), tconfigs.get_preset("tiny")
    else:
        jcfg, tcfg = mini_configs("float32")
    params = numpy_params(jcfg, seed=3)
    state = params_from_jax(params)
    model = tvlm.OpticalVLM(tcfg)
    model.load_state_dict(state, strict=True)  # every key, every shape
    loaded = model.state_dict()
    leaves = list(_flat(params))
    assert len(leaves) == len(state) == len(loaded)
    for path, want in leaves:
        got = _back_to_flax(path, loaded[_torch_key(path)]).reshape(want.shape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_ocr_real_state_dict_shape():
    """At ocr_real width the port's modules take exactly the JAX package's
    parameters: 136 tensors, 29,305,152 params. The flax side is shapes only
    (eval_shape), so nothing of full size is initialized."""
    shapes = param_shapes(jconfigs.get_preset("ocr_real"))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = params_from_jax(zeros)
    with torch.device("meta"):
        port = tvlm.OpticalVLM(tconfigs.get_preset("ocr_real")).state_dict()
    assert len(port) == len(state) == 136
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape) for k, v in state.items()}
    assert sum(v.numel() for v in port.values()) == 29_305_152
