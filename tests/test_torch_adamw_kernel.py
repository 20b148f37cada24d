"""AdamW's kernels (kernels/adamw.cu) and the routing in
train/train_step.py::AdamW.

On the CPU: each leaf's chunks and the table's words at the edge sizes (1
element, odd, not a multiple of the 16-byte vector, one chunk and one more,
a leaf without elements, ADAMW_MAX_LEAVES leaves); leaves on the CPU take
the plain path and launch nothing; leaves off the CPU that the kernels do
not take raise (mixed devices, a dtype other than f32/bf16, a leaf that is
not contiguous, more than ADAMW_MAX_LEAVES leaves; `meta` tensors stand for
a device that is not the CPU here); the plain path's global norm adds the
leaves' rounded sums one at a time in the parameters' order.

On the card (marked `gpu`, skipped without a CUDA device): the update
kernel, given the sums of squares the plain path computed, leaves p, mu and
nu bit-equal to the plain path on the CPU over 3 steps, for f32 and bf16
leaves, with the clip active, inactive and absent, and at ADAMW_MAX_LEAVES
leaves; the sums of squares against a float64 sum, and the same bits twice;
no host synchronisation in `opt.update`; `.grad` unchanged;
`kernels.launches` counting the kernels' launches on a `train_step`. tests/test_torch_moe_train.py holds the plain path equal
to optax. This file imports nothing of JAX. On the GPU machine, from the
repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_adamw_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.train import train_step as ts

CHUNK = kernels.ADAMW_CHUNK
MAX_LEAVES = kernels.ADAMW_MAX_LEAVES
LR = 1e-3
STEPS = 3
# Leaf sizes at the edges of the kernels' cuts: 1 element, odd, one short of
# and one past a 16-byte vector of bf16 (8) and of f32 (4), a chunk, one
# short of it and one past it, two chunks and an odd tail.
EDGE_SIZES = (1, 3, 7, 9, 13, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5, 3 * CHUNK + 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("numels", [
    (1,), (7,), (CHUNK - 1,), (CHUNK,), (CHUNK + 1,), (0, 5), (0,), EDGE_SIZES,
    (1,) * MAX_LEAVES, (0,) * MAX_LEAVES, tuple(range(MAX_LEAVES)),
    (CHUNK * 5 + 1,) * (MAX_LEAVES - 3) + (0, 0, 9),
])
def test_leaves_cut_into_chunks(numels):
    starts = kernels.adamw_chunks(numels)
    assert starts == tuple(np.concatenate([[0], np.cumsum([-(-n // CHUNK) for n in numels])]))
    # Every element lies in exactly one chunk of its leaf.
    for i, n in enumerate(numels):
        chunks = starts[i + 1] - starts[i]
        assert (chunks - 1) * CHUNK < n <= chunks * CHUNK or n == chunks == 0


def test_chunks_refuse_no_leaves_too_many_and_past_int32_chunks():
    with pytest.raises(ValueError, match="no leaves"):
        kernels.adamw_chunks(())
    with pytest.raises(ValueError, match=f"at most {MAX_LEAVES}"):
        kernels.adamw_chunks((1,) * (MAX_LEAVES + 1))
    with pytest.raises(ValueError, match="int32"):
        kernels.adamw_chunks((2**31 * CHUNK,))
    with pytest.raises(ValueError, match="int32"):
        kernels.adamw_chunks((2**30 * CHUNK,) * 2)
    assert kernels.adamw_chunks(((2**31 - 1) * CHUNK,))[-1] == 2**31 - 1


def test_table_words_hold_sizes_kinds_and_addresses():
    base = torch.zeros(64)
    grads = [torch.zeros(9, dtype=torch.bfloat16), base[1:10], torch.zeros(CHUNK + 1)]
    params = [torch.zeros_like(g) for g in grads]
    starts = kernels.adamw_chunks(tuple(g.numel() for g in grads))
    words = list(kernels._adamw_table(starts, grads, params, params, params))
    n = len(grads)
    assert words[:n + 1] == [0, 1, 2, 4]
    assert words[n + 1:2 * n + 1] == [9, 9, CHUNK + 1]
    # bf16 and aligned; f32 and 4 bytes off a 16-byte boundary; f32 aligned.
    assert words[2 * n + 1:3 * n + 1] == [3, 0, 2]
    assert words[3 * n + 1:4 * n + 1] == [g.data_ptr() for g in grads]
    assert words[4 * n + 1:] == [p.data_ptr() for p in params] * 3
    # The sums of squares read g alone; its alignment decides.
    words = list(kernels._adamw_table(starts, grads))
    assert words[2 * n + 1:3 * n + 1] == [3, 0, 2] and words[4 * n + 1:] == [0] * 3 * n


def _leaves(device="cpu", dtypes=(torch.float32, torch.bfloat16), shape=(4, 6)):
    params = {f"w{i}": torch.full(shape, 0.5, dtype=d, device=device) for i, d in enumerate(dtypes)}
    for p in params.values():
        p.grad = torch.full_like(p, 0.25)
    return params


def test_cpu_leaves_take_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was called for CPU leaves")

    for name in ("adamw_sumsq", "adamw_update"):
        monkeypatch.setattr(kernels, name, refuse)
    kernels.reset_launch_counts()
    params = _leaves()
    opt = ts.make_optimizer(LR)
    state = opt.update(params, opt.init(params))
    assert state.count == 1 and not torch.equal(params["w0"], torch.full((4, 6), 0.5))
    assert kernels.launches["adamw_sumsq"] == kernels.launches["adamw_update"] == 0


def test_mixed_devices_raise():
    params = _leaves()
    params["w2"] = torch.zeros(3, device="meta")
    params["w2"].grad = torch.zeros(3, device="meta")
    opt = ts.make_optimizer(LR)
    with pytest.raises(ValueError, match="one CUDA device"):
        opt.update(params, opt.init(params))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_a_dtype_the_kernel_lacks_raises_off_the_cpu(dtype):
    params = _leaves("meta", (torch.float32, dtype))
    opt = ts.make_optimizer(LR)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        opt.update(params, opt.init(params))


def test_more_leaves_than_the_table_takes_raise_off_the_cpu(monkeypatch):
    """MAX_LEAVES + 1 leaves: refused off the CPU, before the library is
    loaded, with the clip and without; on the CPU the plain path takes them."""
    monkeypatch.setattr(kernels, "_adamw_lib", lambda: pytest.fail("the library was loaded"))
    for device in ("meta", "cpu"):
        params = {f"w{i}": torch.full((3,), 0.5, device=device) for i in range(MAX_LEAVES + 1)}
        for p in params.values():
            p.grad = torch.full((3,), 0.25, device=device)
        for opt in (ts.make_optimizer(LR), ts.AdamW(LR)):
            if device == "cpu":
                assert opt.update(params, opt.init(params)).count == 1
            else:
                with pytest.raises(ValueError, match=f"at most {MAX_LEAVES}"):
                    opt.update(params, opt.init(params))
    assert not torch.equal(params["w700"], torch.full((3,), 0.5))


def test_a_leaf_that_is_not_contiguous_raises_off_the_cpu():
    params = _leaves("meta")
    params["w1"] = torch.zeros(6, 4, device="meta").t()
    params["w1"].grad = torch.zeros(6, 4, device="meta").t()
    opt = ts.make_optimizer(LR)
    with pytest.raises(ValueError, match="contiguous"):
        opt.update(params, opt.init(params))


def test_plain_norm_adds_leaf_sums_in_order():
    """Sums of squares 2**24, then 32 ones: added in order, each 1 is lost
    (2**24 + 1 rounds back to 2**24 in f32), so the norm is 4096, where a
    pairwise sum would give 2**24 + 32. The first moment after one step,
    (1 - b1) times the gradient divided by the norm, shows which."""
    n = 33
    params = {f"w{i}": torch.zeros(8) for i in range(n)}
    for p in params.values():
        p.grad = torch.full((8,), 3.0)
    forced = torch.tensor([2.0**24] + [1.0] * (n - 1))
    opt = ts.make_optimizer(LR)
    state = opt.update(params, opt.init(params), reduce_sq=lambda names, sq: forced.clone())
    norm = np.float32(0)
    for x in forced.numpy():
        norm = np.float32(norm + x)
    assert norm == np.float32(2.0**24)
    g = np.float32(np.float32(3.0) / np.sqrt(norm)) * np.float32(1.0)
    want = np.float32(g * np.float32(1 - 0.9))
    assert all(float(m[0]) == float(want) for m in state.mu.values())


def test_plain_square_root_is_ieee():
    """The plain path's square root against numpy's f32 root (IEEE's,
    correctly rounded) on f32 values over the whole range, subnormals
    included, and on bf16 values: the same bits. torch's vectorised f32
    root on the CPU is not correctly rounded, and the kernel's __fsqrt_rn
    is."""
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal(1 << 16)).astype(np.float32)
    x *= (np.float32(2.0) ** rng.integers(-149, 127, x.shape).astype(np.float32)).astype(np.float32)
    x = x[np.isfinite(x)]
    got = ts._sqrt_rn(torch.from_numpy(x)).numpy()
    assert (got.view(np.int32) == np.sqrt(x).view(np.int32)).all()
    b = torch.from_numpy(x).to(torch.bfloat16)
    want = torch.from_numpy(np.sqrt(b.float().numpy())).to(torch.bfloat16)
    assert torch.equal(ts._sqrt_rn(b).view(torch.int16), want.view(torch.int16))


def _kernel_arithmetic(opt, params, state, sq, lr, count):
    """adamw.cu's update written out in torch on the CPU, operation by
    operation in f32 with the leaf's rounding after each: the norm as the
    update kernel's prologue adds it, then adam() per element. The CPU's
    f32 products, sums and quotients are IEEE's; its square root is not
    (within about an ulp), so the root is taken in f64 and rounded, which
    gives IEEE's f32 root. Returns {name: (p, mu, nu)}."""
    bc1 = float(1 - np.float32(opt.b1) ** np.float32(count))
    bc2 = float(1 - np.float32(opt.b2) ** np.float32(count))
    clip, norm = False, None
    if sq is not None:
        acc = torch.zeros((), dtype=torch.float32)
        for s, p in zip(sq, params.values()):
            acc = acc + (s.to(torch.bfloat16).float() if p.dtype == torch.bfloat16 else s)
        norm = acc.double().sqrt().float()
        clip = bool(norm >= float(np.float32(opt.max_norm)))
    out = {}
    for name, p in params.items():
        dtype = p.dtype
        c = opt._constants(dtype, lr, bc1, bc2)

        def r(x):
            return x.to(torch.bfloat16).float() if dtype == torch.bfloat16 else x

        g, m, v, q = p.grad.float(), state.mu[name].float(), state.nu[name].float(), p.float()
        if clip:
            g = r(g / r(norm))
            g = r(g * c["max_norm"])
        m = r(r(m * c["b1"]) + r(g * c["1 - b1"]))
        v = r(r(v * c["b2"]) + r(r(g * g) * c["1 - b2"]))
        d = r(r(r(v / c["bc2"]).double().sqrt().float()) + c["eps"])
        step = r(r(m / c["bc1"]) / d)
        if opt.weight_decay:
            step = r(step + r(q * c["weight_decay"]))
        q = r(q + r(step * c["-lr"]))
        out[name] = tuple(t.to(dtype) for t in (q, m, v))
    return out


@pytest.mark.parametrize("clip", ["active", "inactive", "absent"])
def test_kernel_arithmetic_equals_the_plain_path_on_the_cpu(clip):
    """The sequence adamw.cu computes, emulated here, against the plain path
    over 3 steps at every edge size in f32 and bf16: the same bits. (The
    kernel itself is held to the plain path on the card below.)"""
    rng = np.random.default_rng({"active": 11, "inactive": 12, "absent": 13}[clip])
    scale = 0.05 if clip == "active" else 5e-4
    params = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in EDGE_SIZES:
            params[f"{str(dtype)[6:]}_{n}"] = torch.tensor(rng.standard_normal(n).astype(np.float32) * 0.1).to(dtype)
    opt = ts.AdamW(LR) if clip == "absent" else ts.make_optimizer(LR)
    state = opt.init(params)
    for step in range(STEPS):
        for p in params.values():
            p.grad = torch.tensor(rng.standard_normal(p.numel()).astype(np.float32) * scale).to(p.dtype)
        before = ts.OptState({k: t.clone() for k, t in state.mu.items()}, {k: t.clone() for k, t in state.nu.items()},
                             state.count)
        start = {k: p.clone() for k, p in params.items()}
        seen = []

        def keep(names, sq):
            seen.append(sq.clone())
            return sq

        state = opt.update(params, state, reduce_sq=None if clip == "absent" else keep)
        if clip != "absent":
            assert (clip == "active") == bool(sum(seen[0]) ** 0.5 >= 1.0)
        for name, p in start.items():
            p.grad = params[name].grad
        want = _kernel_arithmetic(opt, start, before, seen[0] if seen else None, LR, step + 1)
        for name, (q, m, v) in want.items():
            for what, got, exp in (("p", params[name], q), ("mu", state.mu[name], m), ("nu", state.nu[name], v)):
                assert torch.equal(_bits(got), _bits(exp)), (step, what, name)


# ------------------------------------------------------------- the card


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _edge_leaves(rng, scale: float) -> dict:
    """{name: (f32 values, dtype)}: every edge size in bf16 and in f32."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in EDGE_SIZES:
            out[f"{str(dtype)[6:]}_{n}"] = ((rng.standard_normal(n) * scale).astype(np.float32), dtype)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["active", "inactive", "absent"])
def test_update_is_bit_equal_to_the_plain_path_on_the_cpu(cuda, clip):
    """Three steps of f32 and bf16 leaves at every edge size, one bf16 and
    one f32 leaf 2 bytes / 4 bytes off a 16-byte boundary (the element-wise
    route), from the same gradients: the card's p, mu and nu equal the
    CPU's bit for bit. The card's update is given the sums of squares the
    CPU computed, through `reduce_sq`."""
    rng = np.random.default_rng({"active": 1, "inactive": 2, "absent": 3}[clip])
    # Global norm about 19 (clipped at 1) or 0.19 (not clipped).
    scale = 0.05 if clip == "active" else 5e-4
    leaves = _edge_leaves(rng, 0.1)
    params = {"cpu": {}, "cuda": {}}
    for name, (values, dtype) in leaves.items():
        for dev in params:
            params[dev][name] = torch.tensor(values).to(dtype).to(dev)
    for dtype, offset in ((torch.bfloat16, 1), (torch.float32, 1)):
        values = rng.standard_normal(CHUNK + 3).astype(np.float32) * 0.1
        for dev in params:
            base = torch.zeros(CHUNK + 3 + offset, dtype=dtype, device=dev)
            base[offset:] = torch.tensor(values).to(dtype)
            params[dev][f"unaligned_{str(dtype)[6:]}"] = base[offset:]
    assert params["cuda"]["unaligned_bfloat16"].data_ptr() % 16 == 2
    _card_equals_cpu(params, clip, rng, scale)


def _card_equals_cpu(params: dict, clip: str, rng, scale: float) -> None:
    """STEPS updates of params["cpu"] and params["cuda"] (the same leaves)
    from the same gradients, `scale` times normals: the card's p, mu and nu
    equal the CPU's bit for bit after each, the card given the CPU's sums of
    squares through `reduce_sq`; each step's launches counted."""
    make = (lambda: ts.AdamW(LR)) if clip == "absent" else (lambda: ts.make_optimizer(LR))
    opts = {dev: make() for dev in params}
    states = {dev: opts[dev].init(params[dev]) for dev in params}
    kernels.reset_launch_counts()
    for step in range(STEPS):
        grads = {name: rng.standard_normal(p.numel()).astype(np.float32) * scale for name, p in params["cpu"].items()}
        seen = []

        def keep(names, sq):
            seen.append(sq.clone())
            return sq

        for dev in ("cpu", "cuda"):
            for name, p in params[dev].items():
                p.grad = torch.tensor(grads[name]).to(p.dtype).to(dev)
            reduce_sq = keep if dev == "cpu" else (lambda names, sq: seen[0].to(sq.device))
            states[dev] = opts[dev].update(params[dev], states[dev],
                                           reduce_sq=None if clip == "absent" else reduce_sq)
        if clip != "absent":
            norm = float(sum(s.to(params["cpu"][k].dtype).float() for s, k in zip(seen[0], params["cpu"])) ** 0.5)
            assert (norm >= 1.0) == (clip == "active"), norm
        for name in params["cpu"]:
            for what, cpu, card in (("p", params["cpu"][name], params["cuda"][name]),
                                    ("mu", states["cpu"].mu[name], states["cuda"].mu[name]),
                                    ("nu", states["cpu"].nu[name], states["cuda"].nu[name])):
                assert card.dtype == cpu.dtype
                assert torch.equal(_bits(card), _bits(cpu)), (step, what, name)
    # Each step: the partial sums and the leaves' sums with the clip, then the update.
    assert kernels.launches["adamw_update"] == STEPS
    assert kernels.launches["adamw_sumsq"] == (0 if clip == "absent" else 2 * STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["active", "absent"])
def test_update_of_the_most_leaves_is_bit_equal_to_the_plain_path(cuda, clip):
    """ADAMW_MAX_LEAVES leaves in one table (the kernel arguments' whole
    32,764 bytes), bf16 and f32 in turn, of 1 to 40 elements and every
    tenth one past a chunk: the card equal to the CPU over 3 steps."""
    rng = np.random.default_rng({"active": 4, "absent": 6}[clip])
    params = {"cpu": {}, "cuda": {}}
    for i in range(MAX_LEAVES):
        n = CHUNK + 1 + i if i % 10 == 9 else 1 + i % 40
        dtype = torch.bfloat16 if i % 2 else torch.float32
        values = rng.standard_normal(n).astype(np.float32) * 0.1
        for dev in params:
            params[dev][f"w{i:03d}"] = torch.tensor(values).to(dtype).to(dev)
    _card_equals_cpu(params, clip, rng, 0.01 if clip == "active" else 1e-4)


@pytest.mark.gpu
def test_sums_of_squares_against_float64_and_twice_the_same_bits(cuda):
    """Each leaf's sum of squares against a float64 sum of the same values:
    relative error at most max(that of vector_norm(dtype=float32).square()
    on the leaf, 2**-22), a floor of 4 f32 ulps since on a small leaf both
    can land within an ulp or two of the exact sum by luck; and at most the
    worst case of the kernel's order of summation for non-negative terms,
    d * 2**-24 with d the longest chain of roundings (a thread's elements
    of a chunk, 5 shuffle levels, 8 warps, a thread's chunks of the leaf, 5
    and 8 again). Two calls on the same gradients give the same bits."""
    rng = np.random.default_rng(5)
    sizes = EDGE_SIZES + (1 << 22, 3 * (1 << 20) + 7)
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        for n in sizes:
            grads.append(torch.tensor(rng.standard_normal(n).astype(np.float32) * 0.3).to(dtype).to(cuda))
    sq = kernels.adamw_sumsq(grads)
    again = kernels.adamw_sumsq(grads)
    assert torch.equal(_bits(sq), _bits(again))
    for g, got in zip(grads, sq.cpu().tolist()):
        exact = float((g.double() ** 2).sum())
        torch_sq = float(torch.linalg.vector_norm(g, dtype=torch.float32).square())
        err, torch_err = abs(got - exact) / exact, abs(torch_sq - exact) / exact
        per_thread = -(-CHUNK // 256)
        chunks = -(-g.numel() // CHUNK)
        depth = per_thread + 5 + 8 + -(-chunks // 256) + 5 + 8
        assert err <= max(torch_err, 2.0**-22), (g.dtype, g.numel(), err, torch_err)
        assert err <= depth * 2.0**-24, (g.dtype, g.numel(), err, depth)


@pytest.mark.gpu
def test_update_syncs_nothing_and_leaves_the_gradients(cuda):
    """`opt.update` on card leaves under the sync debug mode "error" raises
    nothing, the first call (which loads the library) and later ones; every
    `.grad` holds the step's unclipped gradient afterwards."""
    kernels.build("adamw")
    rng = np.random.default_rng(7)
    params = {f"w{i}": torch.tensor(rng.standard_normal(n).astype(np.float32)).to(d).to(cuda)
              for i, (n, d) in enumerate(zip(EDGE_SIZES, [torch.bfloat16, torch.float32] * 5))}
    opt = ts.make_optimizer(LR)
    state = opt.init(params)
    torch.cuda.synchronize()
    for _ in range(2):
        for p in params.values():
            p.grad = torch.tensor(rng.standard_normal(p.numel()).astype(np.float32) * 5).to(p.dtype).to(cuda)
        before = {k: p.grad.clone() for k, p in params.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = opt.update(params, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for k, p in params.items():
            assert torch.equal(_bits(p.grad), _bits(before[k])), k


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take_on_the_card(cuda):
    opt = ts.make_optimizer(LR)
    mixed = _leaves(cuda)
    mixed["w2"] = torch.zeros(3)
    mixed["w2"].grad = torch.zeros(3)
    half = _leaves(cuda, (torch.float32, torch.float16))
    strided = _leaves(cuda)
    strided["w1"] = torch.zeros(6, 4, device=cuda).t()
    strided["w1"].grad = torch.zeros(6, 4, device=cuda).t()
    for params, match in ((mixed, "one CUDA device"), (half, "float32 or bfloat16"), (strided, "contiguous")):
        with pytest.raises(ValueError, match=match):
            opt.update(params, opt.init(params))


@pytest.mark.gpu
def test_train_step_launches_both_kernels_once_a_step(cuda):
    """Two `train_step`s of `tiny` on the card: two sums-of-squares launches
    (the partial sums, the leaves' sums) and one update launch a step, the
    loss finite."""
    from vision_compression_project_tpu_torch.models import get_preset
    from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID

    cfg = get_preset("tiny")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
                              decoder=dataclasses.replace(cfg.decoder, dtype="float32"))
    rng = np.random.default_rng(0)
    v = cfg.vision
    batch = {"patch_tokens": torch.tensor(rng.standard_normal((2, v.grid * v.grid, v.patch * v.patch * 3)),
                                          dtype=torch.float32, device=cuda),
             "token_ids": torch.tensor(rng.integers(0, cfg.decoder.vocab, size=(2, 32)), device=cuda)}
    batch["token_ids"][:, 0] = BOS_ID
    model, opt, state = ts.make_train_state(cfg, device=cuda, seed=0, lr=LR)
    kernels.reset_launch_counts()
    for step in range(2):
        state, loss = ts.train_step(model, opt, state, batch)
        assert bool(torch.isfinite(loss))
        assert (kernels.launches["adamw_sumsq"], kernels.launches["adamw_update"]) == (2 * (step + 1), step + 1)
