"""The page reader: vision encoder + projector + LM decoder, and the runner
that turns page rasters into page-JSON dicts by greedy decoding. The port of
vision_compression_project_tpu/models/vlm.py (OpticalVLM, _task_logit_mask,
VLMRunner's extraction and answer paths).

Extraction takes page pixels (`extract_batch`, `extract_batch_async`) or a
page's glyphs and rects, drawn on the device first
(`extract_batch_async_glyphs`, ops/glyph_render.py); `collect_extract` turns
a batch's tokens into page dicts. The decoder emits `markdown <SEP> summary
<SEP> entity (<US> entity)* <EOS>`; the host splits the tokens into
{page_number, markdown, entities, summary}. Answering: the decoder reads `BOS TASK_ANSWER question
SEP evidence SEP` behind a blank page's vision tokens and emits the answer's
text up to EOS.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.glyph_render import pack_primitives, render_pages_from_glyphs
from ..ops.preprocess import preprocess_pages
from .configs import VLMConfig
from .decoder import Decoder
from ..parallel.mesh import AXIS_DATA, AXIS_SEQ, axis_size
from ..parallel.sharding import keep_shards, local_shard, use_mesh
from ..parallel.tensor_parallel import gather_cat, sum_over
from .layers import Dense, init_weights_, normal_, seq_mesh, torch_dtype, whole_sequence
from .tokenizer import BOS_ID, EOS_ID, PAD_ID, SEP_ID, TASK_ANSWER_ID, TASK_EXTRACT_ID, get_tokenizer
from .vit import VisionEncoder

UNIT_SEP = 0x1F  # byte separating entity list items inside the entities field

PROMPT_BUCKET = 64   # prompt lengths are padded up to a multiple of this
CACHE_BUCKET = 128   # KV cache lengths are padded up to a multiple of this
MAX_NEW = 256        # tokens decoded per page or answer unless the caller asks for fewer
# Evidence-vs-decode split for answer(): trained answers fit in ~256 tokens
# and end with EOS, so evidence packing reserves this much; a larger max_new
# extends the decode bound into whatever context the real prompt leaves.
ANSWER_DECODE_RESERVE = 256

_MASK_CACHE: Dict[Tuple[str, str], np.ndarray] = {}


def _task_logit_mask(tok, kind: str) -> np.ndarray:
    """Additive (vocab,) f32 mask constraining a task to its output grammar,
    built once per (tokenizer, kind).

    Text tokens are allowed when their byte expansion holds only printable or
    whitespace bytes. 'extract' also allows SEP, US and EOS; 'answer' allows
    EOS only."""
    key = (tok.cache_key, kind)
    cached = _MASK_CACHE.get(key)
    if cached is not None:
        return cached
    allowed_bytes = set(range(0x20, 0x7F)) | set(range(0x80, 0x100)) | {0x09, 0x0A}
    mask = np.full((tok.vocab_size,), -1e30, np.float32)
    for tid, exp in tok.expansions().items():
        if exp and all(b in allowed_bytes for b in exp):
            mask[tid] = 0.0
    if kind == "extract":
        mask[np.asarray([SEP_ID, EOS_ID, UNIT_SEP])] = 0.0
    elif kind == "answer":
        mask[EOS_ID] = 0.0
    else:
        raise ValueError(f"unknown task {kind!r}")
    _MASK_CACHE[key] = mask
    return mask


class OpticalVLM(nn.Module):
    def __init__(self, cfg: VLMConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionEncoder(cfg.vision)
        self.proj = Dense(cfg.vision.dim_global, cfg.decoder.dim, False, torch_dtype(cfg.decoder.dtype))
        self.decoder = Decoder(cfg.decoder)

    def encode_pages(self, patch_tokens: torch.Tensor) -> torch.Tensor:
        return self.proj(self.vision(patch_tokens))

    def forward(
        self, patch_tokens: torch.Tensor, token_ids: torch.Tensor, kv_len: Optional[torch.Tensor] = None,
        aux_losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Training/eval forward: logits over the [vision ; text] sequence;
        the decoder's MoE terms go to `aux_losses` (Decoder.forward). Under
        a mesh whose `seq` dimension holds n > 1 ranks, as the reference's
        global view computes it: every `seq` rank runs the vision encoder on
        its pages whole, and the decoder takes this rank's chunk of
        [vision ; text] and returns that chunk's logits; a length that does
        not divide n runs whole on every `seq` rank (`whole_sequence`)."""
        vis = self.encode_pages(patch_tokens)
        txt = self.decoder.embed_tokens(token_ids)
        x = torch.cat([vis, txt.to(vis.dtype)], dim=1)
        total_len = None if kv_len is None else kv_len + vis.shape[1]
        mesh = seq_mesh()
        if mesh is None:
            return self.decoder(x, kv_len=total_len, aux_losses=aux_losses)
        if x.shape[1] % axis_size(mesh, AXIS_SEQ):
            with whole_sequence():
                return self.decoder(x, kv_len=total_len, aux_losses=aux_losses)
        return self.decoder(local_shard(x, mesh, (None, "seq", None)), kv_len=total_len, aux_losses=aux_losses)

    def prefill_mixed(
        self,
        vision_emb: Optional[torch.Tensor],
        prompt_ids: torch.Tensor,
        kv_len: torch.Tensor,
        cache_len: Optional[int] = None,
    ):
        """Prefill over [vision ; prompt]: (hidden states, caches)."""
        txt = self.decoder.embed_tokens(prompt_ids)
        x = txt if vision_emb is None else torch.cat([vision_emb, txt.to(vision_emb.dtype)], dim=1)
        return self.decoder.prefill(x, kv_len=kv_len, cache_len=cache_len)

    def decode_ids(self, ids: torch.Tensor, caches, pos):
        return self.decoder.decode_step(self.decoder.embed_tokens(ids[:, None]), caches, pos)


@torch.no_grad()
def init_params(model: OpticalVLM, seed: int) -> None:
    """Fill `model` with seeded random weights, with the initializers the JAX
    package uses: lecun-normal kernels, zero biases, unit norm scales, N(0,
    0.02) position and token embeddings. The draws come from one CPU
    generator, a tensor at a time, and are copied to wherever the model
    lies: same seed, same weights on any device."""
    g = torch.Generator().manual_seed(seed)
    init_weights_(model, g)
    normal_(model.vision.pos_embed, 0.02, g)


class VLMRunner:
    """Owns the model and presents batched page extraction and answering.

    Weights are seeded random unless `params` (a state_dict, e.g. from
    `weights.params_from_jax` or `train.checkpoint.load_runner`) is given.
    Runs on `device`, "cuda" unless the caller asks for "cpu". Extraction and
    answers decode at most `max_new_default` tokens unless a call asks for
    another bound.

    With a `mesh` (of the device's type; every rank constructs the runner
    and makes the same calls), the reference's multi-chip serving: each
    rank keeps its shard of the whole parameters
    (`parallel.sharding.shard_params`), a page batch goes over `data` (each
    rank encodes and decodes its rows, and the tokens are gathered, so every
    rank returns the whole batch's pages), and prefill and decode run the
    `model` and `expert` shards on local heads and a local KV cache, the
    logits gathered before the grammar mask and the argmax. The decode loop
    stops once every row of every `data` rank has emitted EOS. Under a `seq`
    dimension of more than one rank, generation raises, as the whole-sequence
    prefill and decode do."""

    def __init__(
        self,
        cfg: VLMConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        max_new_default: int = MAX_NEW,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VLMRunner: device 'cuda' asked for, but no CUDA device is available")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"VLMRunner: a {mesh.device_type} mesh for a runner on {self.device}")
        self.mesh = mesh
        self.cfg = cfg
        self.max_new_default = max_new_default
        self.tok = get_tokenizer(cfg)
        # Parameters are made on the runner's device and filled there, so a
        # model as large as prod (25 GB) never lies whole in host memory.
        with torch.device(self.device):
            model = OpticalVLM(cfg)
        if params is None:
            init_params(model, seed)
        else:
            model.load_state_dict(params)
        if mesh is not None:
            keep_shards(model, mesh)
        self.model = model.to(self.device).eval()
        self._masks: Dict[str, torch.Tensor] = {}
        self._blank_vis: Optional[torch.Tensor] = None

    def logit_mask(self, task: str) -> torch.Tensor:
        """The task's (vocab,) logit mask on the device; a model vocab past
        the tokenizer's is closed."""
        if task not in self._masks:
            mask = _task_logit_mask(self.tok, task)
            extra = self.cfg.decoder.vocab - mask.shape[0]
            if extra:
                mask = np.concatenate([mask, np.full((extra,), -1e30, np.float32)])
            self._masks[task] = torch.from_numpy(mask).to(self.device)
        return self._masks[task]

    @torch.inference_mode()
    def preprocess_patches(self, pages_u8: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """uint8 pages (host array or tensor) -> bf16 patch tokens (bf16
        whatever the model dtype, as in the reference)."""
        cfg = self.cfg.vision
        if isinstance(pages_u8, torch.Tensor):
            pages = pages_u8.to(self.device)
        else:
            pages = torch.as_tensor(np.ascontiguousarray(pages_u8)).to(self.device)
        return preprocess_pages(
            pages, target_h=cfg.image_size, target_w=cfg.image_size, patch=cfg.patch
        )

    def _on_mesh(self):
        """The runner's mesh as the active mesh, or nothing without one."""
        return contextlib.nullcontext() if self.mesh is None else use_mesh(self.mesh)

    def _local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's `data` rows of a page batch (all of them without a mesh)."""
        return x if self.mesh is None else local_shard(x, self.mesh, ("batch",) + (None,) * (x.dim() - 1))

    @torch.inference_mode()
    def encode(self, patches: torch.Tensor) -> torch.Tensor:
        with self._on_mesh():
            return self.model.encode_pages(patches)

    def pad_prompts(self, prompts: Sequence[Sequence[int]]) -> Tuple[torch.Tensor, List[int]]:
        """(B, plen) ids, plen bucketed up to PROMPT_BUCKET, and true lengths."""
        plen = max(8, -(-max(len(p) for p in prompts) // PROMPT_BUCKET) * PROMPT_BUCKET)
        ids = np.full((len(prompts), plen), PAD_ID, np.int64)
        lens = []
        for i, p in enumerate(prompts):
            p = list(p)[:plen]
            ids[i, : len(p)] = p
            lens.append(len(p))
        return torch.as_tensor(ids, device=self.device), lens

    @torch.inference_mode()
    def first_logits(
        self, ids: torch.Tensor, lens: List[int], vision_emb: Optional[torch.Tensor], cache_len: int,
    ) -> Tuple[torch.Tensor, list, torch.Tensor]:
        """Prefill over [vision ; prompt ids]: (logits (B, vocab) at each
        row's last real position, caches padded to cache_len, kv_len (B,))."""
        vis_len = 0 if vision_emb is None else vision_emb.shape[1]
        kv_len = torch.as_tensor(lens, dtype=torch.int32, device=self.device) + vis_len
        with self._on_mesh():
            h, caches = self.model.prefill_mixed(vision_emb, ids, kv_len, cache_len)
            last = h[torch.arange(h.shape[0], device=self.device), kv_len.long() - 1]
            return self.model.decoder.hidden_to_logits(last), caches, kv_len

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        vision_emb: Optional[torch.Tensor],
        max_new: int,
        task: str = "extract",
    ) -> torch.Tensor:
        """Greedy decoding under the task's logit mask: (B, max_new) token ids,
        PAD after a row's EOS. Stops early once every row has emitted EOS."""
        b = len(prompts)
        ids, lens = self.pad_prompts(prompts)
        plen = ids.shape[1]
        vis_len = 0 if vision_emb is None else vision_emb.shape[1]
        max_seq = self.cfg.decoder.max_seq
        # The decode position must stay inside the model context.
        max_new = max(1, min(max_new, max_seq - vis_len - plen))
        cache_len = min(max_seq, -(-(vis_len + plen + max_new) // CACHE_BUCKET) * CACHE_BUCKET)
        mask = self.logit_mask(task)[None, :]

        logits, caches, kv_len = self.first_logits(ids, lens, vision_emb, cache_len)
        # Lockstep batch (one prompt length): decode writes the cache at one
        # host-side position; otherwise each row carries its own position.
        pos: Union[int, torch.Tensor] = (
            lens[0] + vis_len if all(n == lens[0] for n in lens) else kv_len.long()
        )
        first = torch.argmax(logits + mask, dim=-1)
        out = torch.full((b, max_new), PAD_ID, dtype=torch.long, device=self.device)
        done = first == EOS_ID
        out[:, 0] = first
        last_tok = first
        for i in range(1, max_new):
            if self._all_done(done):
                break
            with self._on_mesh():
                step_logits, caches = self.model.decode_ids(last_tok, caches, pos)
            tok = torch.argmax(step_logits + mask, dim=-1)
            tok = torch.where(done, torch.full_like(tok, PAD_ID), tok)
            out[:, i] = tok
            done = done | (tok == EOS_ID)
            last_tok = tok
            pos = pos + 1
        return out

    def _all_done(self, done: torch.Tensor) -> bool:
        """Whether every row has emitted EOS: this rank's rows, and with a
        mesh those of every `data` rank, so all ranks decode the same steps."""
        if self.mesh is None:
            return bool(done.all())
        return int(sum_over((~done).sum(), (AXIS_DATA,), self.mesh)) == 0

    def _all_rows(self, toks: torch.Tensor) -> torch.Tensor:
        """The tokens of every `data` rank's rows, in batch order."""
        return toks if self.mesh is None else gather_cat(toks, AXIS_DATA, 0, self.mesh)

    @staticmethod
    def _collect_tokens(toks: torch.Tensor) -> List[List[int]]:
        """Token rows, cut at EOS, without PAD."""
        result = []
        for row in toks.cpu().tolist():
            if EOS_ID in row:
                row = row[: row.index(EOS_ID)]
            result.append([t for t in row if t != PAD_ID])
        return result

    def extract_batch_async(
        self, pages_u8: np.ndarray, page_numbers: List[int], max_new: Optional[int] = None
    ):
        """Encode and decode one batch of (B, H, W), (B, H, W, 1) or
        (B, H, W, 3) uint8 pages; returns a handle for `collect_extract`. The
        batch may be padded past `page_numbers`: collect_extract keeps one
        record per page number."""
        vis = self.encode(self._local_rows(self.preprocess_patches(pages_u8)))
        prompts = [[BOS_ID, TASK_EXTRACT_ID]] * int(vis.shape[0])
        return self._all_rows(self.generate(prompts, vis, max_new or self.max_new_default)), list(page_numbers)

    def extract_batch_async_glyphs(
        self, primitives, render_hw: Tuple[int, int], page_numbers: List[int],
        max_new: Optional[int] = None,
    ):
        """The glyph-transport variant: pages arrive as (glyphs, rects) from
        `PdfDocument.page_primitives` and are drawn at (h, w) = render_hw on
        the device (ops/glyph_render.py) before the same encode and decode."""
        h, w = render_hw
        arrays = [torch.from_numpy(a).to(self.device) for a in pack_primitives(primitives)]
        with torch.inference_mode():
            pages_gray = render_pages_from_glyphs(*arrays, h=h, w=w)
        vis = self.encode(self._local_rows(self.preprocess_patches(pages_gray)))
        prompts = [[BOS_ID, TASK_EXTRACT_ID]] * int(vis.shape[0])
        return self._all_rows(self.generate(prompts, vis, max_new or self.max_new_default)), list(page_numbers)

    def collect_extract(self, handle) -> List[Dict]:
        """A batch's tokens -> one {page_number, markdown, entities, summary}
        dict per page number."""
        toks, page_numbers = handle
        out = []
        for page_no, seq in zip(page_numbers, self._collect_tokens(toks)):
            markdown, summary, entities = self._split_fields(seq)
            out.append(
                {"page_number": page_no, "markdown": markdown, "entities": entities, "summary": summary}
            )
        return out

    def extract_batch(
        self, pages_u8: np.ndarray, page_numbers: List[int], max_new: Optional[int] = None
    ) -> List[Dict]:
        """(B, H, W), (B, H, W, 1) or (B, H, W, 3) uint8 pages -> one
        {page_number, markdown, entities, summary} dict per page number."""
        return self.collect_extract(self.extract_batch_async(pages_u8, page_numbers, max_new))

    def _split_fields(self, seq: List[int]) -> Tuple[str, str, List[str]]:
        parts: List[List[int]] = [[]]
        for t in seq:
            if t == SEP_ID:
                parts.append([])
            else:
                parts[-1].append(t)
        markdown = self.tok.decode(parts[0]) if parts else ""
        summary = self.tok.decode(parts[1]) if len(parts) > 1 else ""
        entities: List[str] = []
        if len(parts) > 2:
            current: List[int] = []
            for t in parts[2]:
                if t == UNIT_SEP:
                    if current:
                        entities.append(self.tok.decode(current))
                    current = []
                else:
                    current.append(t)
            if current:
                entities.append(self.tok.decode(current))
        return markdown, summary, entities

    def _blank_vision(self) -> torch.Tensor:
        """Vision tokens of a blank 64x64 white page, encoded once. The answer
        task is trained with a blank page riding the vision tower, so
        generation presents the same prefix."""
        if self._blank_vis is None:
            blank = np.full((1, 64, 64, 3), 255, np.uint8)
            self._blank_vis = self.encode(self.preprocess_patches(blank))
        return self._blank_vis

    def answer_prompt(
        self, question: str, evidence_pack: str, max_new: int = MAX_NEW
    ) -> Tuple[List[int], int]:
        """(prompt ids, decode bound) of one answer, as the reference packs it.

        Evidence budget: the context minus the vision prefix, the question
        head, the trailing SEP and a decode reserve, rounded down to the
        prompt bucket first because the prompt is padded up to it. The decode
        bound then takes every position the real prompt leaves, up to max_new."""
        vis_len = self.cfg.vision.tokens_out
        max_seq = self.cfg.decoder.max_seq
        head = [BOS_ID, TASK_ANSWER_ID] + self.tok.encode(question) + [SEP_ID]
        reserve = min(max_new, ANSWER_DECODE_RESERVE)
        allowed_plen = (max_seq - vis_len - reserve) // PROMPT_BUCKET * PROMPT_BUCKET
        budget = allowed_plen - len(head) - 1
        ev_ids = self.tok.encode(evidence_pack)[: max(0, budget)]
        prompt = head + ev_ids + [SEP_ID]
        plen_bucketed = -(-len(prompt) // PROMPT_BUCKET) * PROMPT_BUCKET
        return prompt, min(max_new, max_seq - vis_len - plen_bucketed)

    def answer(self, question: str, evidence_pack: str, max_new: Optional[int] = None) -> str:
        """Greedy answer text for a question over an evidence pack."""
        prompt, bound = self.answer_prompt(question, evidence_pack, max_new or self.max_new_default)
        toks = self.generate([prompt], self._blank_vision(), bound, task="answer")
        # decode() skips ids with no byte expansion (specials).
        return self.tok.decode(self._collect_tokens(toks)[0])
