"""The pipeline-parallel training step: the port of
vision_compression_project_tpu/train/pp_train.py. Loss and gradients through
the GPipe decoder (train/pp_forward.py), then the optimizer, for a decoder
that is dense or Switch-MoE in every block (`_supports_pp`); a decoder that
mixes them (expert_every > 1) trains on the unpipelined step
(train/train_step.py), as in the reference.

Where the work runs. The vision encoder, the projector and the token
embedding run outside the pipeline on stage 0; the final norm, the unembed
and the f32 cross-entropy run on the last stage over the rank's whole batch.
`pp_vlm_loss` returns each rank's share of the loss, as `vlm_loss` does
under a mesh: the last stage's is its rows' masked cross-entropy over the
mask count of the whole batch (summed over `data`) plus MOE_AUX_WEIGHT times
its rows' share of the Switch term (gpipe's aux: summed over the stages,
averaged over the microbatches); every other stage's share is 0, with the
gradient that drives its part of the pipeline's backward. The shares sum,
over `data` and the pipeline dimension, to the reference's loss, which the
train step returns on every rank.

Which rows form a microbatch. The reference's microbatch i is rows
[i * mb, (i + 1) * mb) of the global batch (mb = B / M). With `data` of D
ranks, rank r holds its share of every microbatch: rows i * mb + r * mb / D
to i * mb + (r + 1) * mb / D (`pp_rows`, `pp_shard_batch`), in microbatch
order; a Switch-MoE block routes over its microbatch's rows on every `data`
rank together (SwitchMoE.routing under `data`), so routing and capacity are
the reference's. Contiguous rows (`shard_batch`) would put other rows into
each microbatch and change them. Where mb does not divide by D, a dense
decoder still runs (rank r takes the rows `tensor_split` gives it of each
microbatch; a dense block does not mix rows); a uniform-MoE decoder raises
ValueError.

The state (`make_pp_train_state`). Each rank keeps its stage's decoder
blocks whole and every parameter outside the decoder blocks, replicated
over the pipeline dimension, with their AdamW moments; the other stages'
blocks are freed. A replicated parameter's gradient is summed over the
pipeline dimension (only the stage that uses it contributes, so the sum is
exact) and every gradient over `data`; the clip's global norm counts each
replicated leaf once and sums the stage leaves over the pipeline dimension.
`gather_pp_state` puts the whole state back together, which a checkpoint
saves as one device's would be. In the reference only the pipeline
dimension is manual inside the pipeline and XLA partitions the rest without
changing the math, experts staying stage-local: here ranks that differ only
in `seq` or `expert` run the same rows, and nothing is summed or sharded
over those dimensions.

Without a mesh, or with a pipeline dimension of one rank, the step is the
reference's degenerate pipeline: the microbatches run through all blocks in
turn, on this process; `virtual_stages` splits them into that many stages
run in this process through the same schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.configs import DecoderConfig, VLMConfig
from ..models.decoder import Decoder
from ..models.tokenizer import PAD_ID
from ..models.vlm import OpticalVLM
from ..parallel.mesh import AXIS_DATA, axis_size
from ..parallel.pipeline import gather_stacked_params
from ..parallel.tensor_parallel import sum_over
from .pp_forward import pipelined_decoder_hidden, stage_blocks, stage_coords, stage_mesh
from .train_step import (
    MOE_AUX_WEIGHT, AdamW, OptState, Params, TrainState, make_optimizer, make_train_state, sum_gradients,
)

PP_REFUSED = "PP needs a uniform decoder (dense or expert_every=1)"
VLM_BLOCKS = "decoder.blocks."   # the decoder blocks' names in OpticalVLM's state_dict
LM_BLOCKS = "blocks."            # and in Decoder's


def _supports_pp(cfg: DecoderConfig) -> bool:
    return cfg.num_experts == 0 or cfg.expert_every == 1


def _uniform_moe(cfg: DecoderConfig) -> bool:
    return cfg.num_experts > 0 and cfg.expert_every == 1


def _data(mesh) -> Tuple[int, int]:
    """(ranks along `data`, this rank's coordinate there)."""
    if mesh is None:
        return 1, 0
    return axis_size(mesh, AXIS_DATA), mesh.get_local_rank(AXIS_DATA)


def pp_rows(batch: int, n_micro: int, n_data: int, rank: int) -> List[int]:
    """The global batch rows `data` rank `rank` holds under PP, in
    microbatch order: its `tensor_split` share of each microbatch's mb rows."""
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not divide into {n_micro} microbatches")
    mb = batch // n_micro
    part = torch.arange(mb).tensor_split(n_data)[rank].tolist()
    return [i * mb + j for i in range(n_micro) for j in part]


def pp_shard_batch(batch: Mapping[str, torch.Tensor], mesh, n_micro: int,
                   uniform_moe: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's rows of a whole batch under PP (`pp_rows`). A batch that
    does not divide into the microbatches raises ValueError, and so does,
    for a uniform-MoE decoder, a microbatch whose rows do not divide over
    `data` (its routing would differ from the reference's)."""
    n_data, rank = _data(mesh)
    b = next(iter(batch.values())).shape[0]
    rows = pp_rows(b, n_micro, n_data, rank)
    if n_data == 1:
        return dict(batch)
    if uniform_moe and (b // n_micro) % n_data:
        raise ValueError(f"microbatches of {b // n_micro} rows do not divide over data of {n_data}: a "
                         "uniform-MoE decoder routes over whole microbatches")
    idx = torch.tensor(rows, dtype=torch.long, device=next(iter(batch.values())).device)
    return {k: v.index_select(0, idx) for k, v in batch.items()}


def _ends(mesh, axis_name: str) -> Tuple[bool, bool]:
    """(whether this rank runs the first stage, whether it runs the last):
    both without a pipeline dimension of more than one rank, where this
    process runs every stage."""
    n_stages = 1 if mesh is None else axis_size(mesh, axis_name)
    if n_stages == 1:
        return True, True
    stage = mesh.get_local_rank(axis_name)
    return stage == 0, stage == n_stages - 1


def _placeholder(shape, dtype, device) -> torch.Tensor:
    """A stage's microbatches when it is not stage 0: only their shape and
    dtype are read (gpipe), so zeros that take no memory."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


def _share(hidden: torch.Tensor, aux: Optional[torch.Tensor]) -> torch.Tensor:
    """A stage's share before the last: 0, with a zero gradient on the
    pipeline's outputs (the last stage's loss gives theirs) and
    MOE_AUX_WEIGHT on its aux, which drives the stage's backward."""
    zero = (hidden.float() * 0).sum()
    return zero if aux is None else zero + MOE_AUX_WEIGHT * (aux - aux.detach())


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's masked f32 cross-entropy sum over the mask count of the
    whole batch (summed over `data`)."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                         reduction="none").view_as(mask)
    count = sum_over(mask.sum(), (AXIS_DATA,), mesh)
    return (ce * mask).sum() / count.clamp(min=1.0)


def _microbatched(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"{b} rows do not divide into {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + x.shape[1:])


def pp_lm_loss(decoder: Decoder, token_ids: torch.Tensor, mesh=None, n_micro: int = 4, axis_name: str = "model",
               virtual_stages: int = 1) -> torch.Tensor:
    """This rank's share of the next-token cross-entropy of a causal LM whose
    blocks run as a GPipe pipeline (the module docstring). token_ids: this
    rank's (B, S + 1) rows (`pp_shard_batch`), PAD_ID-padded, in microbatch
    order. As in the reference, no Switch term is added."""
    cfg = decoder.cfg
    if not _supports_pp(cfg):
        raise AssertionError(PP_REFUSED)
    first, last = _ends(mesh, axis_name)
    ids_in, targets = token_ids[:, :-1], token_ids[:, 1:]
    b, s = ids_in.shape
    with stage_mesh(mesh):
        if first:
            x = _microbatched(decoder.embed_tokens(ids_in), n_micro)
        else:
            x = _placeholder((n_micro, b // n_micro, s, cfg.dim), decoder.dt, token_ids.device)
        hidden = pipelined_decoder_hidden(cfg, decoder, x, mesh, axis_name, virtual_stages=virtual_stages)
        if not last:
            return _share(hidden, None)
        logits = decoder.hidden_to_logits(hidden.reshape(b, s, cfg.dim))
        return _masked_ce(logits, targets, (targets != PAD_ID).float(), mesh)


def pp_vlm_loss(model: OpticalVLM, batch: Mapping[str, torch.Tensor], mesh=None, n_micro: int = 4,
                axis_name: str = "model", virtual_stages: int = 1) -> torch.Tensor:
    """This rank's share of vlm_loss (train_step.py) with the decoder blocks
    run as a GPipe pipeline: next-token cross-entropy over the text segment
    of [vision ; text], plus the Switch term when the decoder is uniformly
    MoE. batch: this rank's rows (`pp_shard_batch`) of {patch_tokens (B, N,
    pd), token_ids (B, T + 1), loss_mask? (B, T + 1)}, in microbatch order."""
    dcfg = model.cfg.decoder
    if not _supports_pp(dcfg):
        raise AssertionError(PP_REFUSED)
    first, last = _ends(mesh, axis_name)
    ids = batch["token_ids"]
    ids_in, targets = ids[:, :-1], ids[:, 1:]
    vis_len = model.cfg.vision.tokens_out
    b, s = ids_in.shape[0], vis_len + ids_in.shape[1]
    with_aux = _uniform_moe(dcfg)
    with stage_mesh(mesh):
        if first:
            vis = model.encode_pages(batch["patch_tokens"])
            txt = model.decoder.embed_tokens(ids_in)
            x = _microbatched(torch.cat([vis, txt.to(vis.dtype)], dim=1), n_micro)
        else:
            x = _placeholder((n_micro, b // n_micro, s, dcfg.dim), model.decoder.dt, ids.device)
        res = pipelined_decoder_hidden(dcfg, model.decoder, x, mesh, axis_name, with_aux=with_aux,
                                       virtual_stages=virtual_stages)
        hidden, aux = res if with_aux else (res, None)
        if not last:
            return _share(hidden, aux)
        logits = model.decoder.hidden_to_logits(hidden.reshape(b, s, dcfg.dim))
        mask = (targets != PAD_ID).float()
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"][:, 1:].float()
        loss = _masked_ce(logits[:, vis_len:], targets, mask, mesh)
        if aux is not None:
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss


def _is_block(name: str, prefix: str) -> bool:
    return name.startswith(prefix)


def _block_index(name: str, prefix: str) -> int:
    return int(name[len(prefix):].split(".", 1)[0])


def pp_stage_params(named: Mapping[str, torch.Tensor], depth: int, mesh, axis_name: str = "model",
                    prefix: str = VLM_BLOCKS) -> Params:
    """The parameters a rank trains under PP: every one outside the decoder
    blocks (names under `prefix`), and its own stage's blocks."""
    n_stages, stage = stage_coords(mesh, axis_name)
    mine = stage_blocks(depth, n_stages, stage)
    return {k: v for k, v in named.items() if not _is_block(k, prefix) or _block_index(k, prefix) in mine}


def pp_train_state(module: torch.nn.Module, opt: AdamW, depth: int, mesh=None, axis_name: str = "model",
                   prefix: str = VLM_BLOCKS) -> TrainState:
    """The TrainState of `module` (OpticalVLM, or a Decoder with prefix
    LM_BLOCKS) under PP: the parameters of `pp_stage_params` and their
    moments. The other stages' blocks are freed."""
    named = dict(module.named_parameters())
    params = pp_stage_params(named, depth, mesh, axis_name, prefix)
    with torch.no_grad():
        for k, p in named.items():
            if k not in params:
                p.data = p.data.new_empty(0)
    return TrainState(params=params, opt_state=opt.init(params), step=0, cfg=module.cfg)


def make_pp_train_state(cfg: VLMConfig, device=None, seed: int = 0, lr=3e-4, mesh=None, axis_name: str = "model",
                        params: Optional[Params] = None):
    """(model, optimizer, TrainState) for PP training: make_train_state's
    seeded OpticalVLM, whole on every rank (optionally loaded with the whole
    state_dict `params` first, a warm start), then `pp_train_state` keeps
    this rank's part. Only a uniform decoder pipelines (AssertionError)."""
    if not _supports_pp(cfg.decoder):
        raise AssertionError(PP_REFUSED)
    model, opt, _ = make_train_state(cfg, device, seed=seed, lr=lr)
    dev = next(model.parameters()).device
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a model on {dev}")
    if params is not None:
        model.load_state_dict(params)
    return model, opt, pp_train_state(model, opt, cfg.decoder.depth, mesh, axis_name)


def pp_sum_gradients(params: Params, mesh, axis_name: str = "model", prefix: str = VLM_BLOCKS) -> None:
    """Every gradient summed over `data`, and a replicated parameter's also
    over the pipeline dimension, in place (a parameter this rank's stage did
    not use counts 0)."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sum_gradients({k: p for k, p in params.items() if _is_block(k, prefix)}, mesh, (AXIS_DATA,))
    sum_gradients({k: p for k, p in params.items() if not _is_block(k, prefix)}, mesh, (AXIS_DATA, axis_name))


def pp_sq(params: Params, mesh, axis_name: str = "model", prefix: str = VLM_BLOCKS):
    """AdamW's `reduce_sq` under PP: the stage leaves' sums of squares summed
    over the pipeline dimension, leaf by leaf in the stage's order (every
    stage holds the same leaves of its own blocks); replicated leaves once."""

    def reduce_sq(names: List[str], sq: torch.Tensor) -> torch.Tensor:
        idx = [i for i, k in enumerate(names) if _is_block(k, prefix)]
        out = sq.clone()
        if idx:
            sel = torch.tensor(idx, device=sq.device)
            out[sel] = sum_over(sq[sel], (axis_name,), mesh)
        return out

    return reduce_sq


def _pp_step(loss_fn: Callable[[], torch.Tensor], opt: AdamW, state: TrainState, mesh, axis_name: str,
             prefix: str):
    """One step: the loss shares' backward, the gradients summed, the update;
    (state, the whole loss on every rank)."""
    for p in state.params.values():
        p.grad = None
    loss = loss_fn()
    loss.backward()
    if mesh is None:
        state.opt_state = opt.update(state.params, state.opt_state)
    else:
        pp_sum_gradients(state.params, mesh, axis_name, prefix)
        state.opt_state = opt.update(state.params, state.opt_state, reduce_sq=pp_sq(state.params, mesh, axis_name,
                                                                                  prefix))
        loss = sum_over(loss.detach(), (AXIS_DATA, axis_name), mesh)
    state.step += 1
    return state, loss.detach()


def make_pp_train_step(decoder: Decoder, mesh=None, lr=3e-4, n_micro: int = 4, axis_name: str = "model",
                       virtual_stages: int = 1):
    """(optimizer, step) for a causal LM trained through the pipeline:
    step(state, token_ids) -> (state, loss), token_ids this rank's rows
    (`pp_shard_batch`), state from `pp_train_state(decoder, optimizer,
    depth, mesh, axis_name, LM_BLOCKS)`; the loss the whole batch's on every
    rank."""
    opt = make_optimizer(lr)

    def step(state: TrainState, token_ids: torch.Tensor):
        return _pp_step(lambda: pp_lm_loss(decoder, token_ids, mesh, n_micro, axis_name, virtual_stages), opt,
                        state, mesh, axis_name, LM_BLOCKS)

    return opt, step


def make_pp_vlm_train_step(model: OpticalVLM, opt: AdamW, mesh=None, n_micro: int = 4, axis_name: str = "model",
                           virtual_stages: int = 1):
    """(step, rows), the counterpart of the reference's (jitted step,
    batch_shardings): step(state, batch) -> (state, loss) with batch this
    rank's rows, which rows(whole batch) gives (`pp_shard_batch`); state from
    `make_pp_train_state`; the loss the whole batch's on every rank. The
    caller's optimizer and TrainState, so warm starts and checkpoints work
    as in the unpipelined step."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        return _pp_step(lambda: pp_vlm_loss(model, batch, mesh, n_micro, axis_name, virtual_stages), opt, state,
                        mesh, axis_name, VLM_BLOCKS)

    def rows(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return pp_shard_batch(batch, mesh, n_micro, _uniform_moe(model.cfg.decoder))

    return step, rows


def _gather_blocks(tree: Params, depth: int, mesh, axis_name: str, prefix: str) -> Params:
    """A dict named like the state's params (this rank's blocks and the
    replicated leaves) -> the whole dict, every stage's blocks gathered over
    the pipeline dimension, in block order where the blocks stood."""
    n_stages, stage = stage_coords(mesh, axis_name)
    mine = stage_blocks(depth, n_stages, stage)
    rel = [k[len(f"{prefix}{mine[0]}."):] for k in tree if k.startswith(f"{prefix}{mine[0]}.")]
    local = {r: torch.stack([tree[f"{prefix}{i}.{r}"].detach() for i in mine])[None] for r in rel}
    stacked = gather_stacked_params(mesh, local, axis_name)
    per = len(mine)
    blocks = {f"{prefix}{s * per + j}.{r}": stacked[r][s, j] for s in range(n_stages) for j in range(per)
              for r in rel}
    out: Params = {}
    for k, v in tree.items():
        if not _is_block(k, prefix):
            out[k] = v.detach()
        elif not out.keys() & blocks.keys():
            out.update(blocks)
    return out


def gather_pp_state(state: TrainState, depth: int, mesh, axis_name: str = "model",
                    prefix: str = VLM_BLOCKS) -> TrainState:
    """The whole TrainState from every stage's part (every rank takes part),
    which a checkpoint saves as one device's would be."""
    if mesh is None or axis_size(mesh, axis_name) == 1:
        return state
    opt = state.opt_state
    return TrainState(
        params=_gather_blocks(state.params, depth, mesh, axis_name, prefix), step=state.step, cfg=state.cfg,
        opt_state=None if opt is None else OptState(
            mu=_gather_blocks(opt.mu, depth, mesh, axis_name, prefix),
            nu=_gather_blocks(opt.nu, depth, mesh, axis_name, prefix), count=opt.count))
