"""Continuous batching for single-token decode serving.

A fixed pool of slots decodes in lockstep (one ``decode_step`` per tick,
every slot, idle ones too); a finished or empty slot is refilled from the
request queue by prefilling the new prompt with batch 1 and splicing its
caches into the slot.  EOS, ``max_new_tokens`` or a length of ``s_max - 1``
retires a slot.  Greedy argmax, first maximum on ties, as the reference.

The reference rebuilds the pool's caches with ``dynamic_update_slice`` over
every leaf of two or more dimensions; here the splice writes the slot's rows
of every cache tensor in place on the device: an attention layer's K/V rows
(the prompt's, zeros past it, which is what the reference's padded row
holds) and length, a Mamba layer's SSM state and conv tail, an RWKV layer's
wkv state, shift and channel-mix shift.  A prompt that breaks the chunk rule
of the Mamba or RWKV scans is refused when it is submitted.  The slots
carry no cross-attention memory, so an encoder-decoder or vision config is
refused (``ValueError``), as the reference's serve demo refuses it.  Each
decode tick reads the new tokens on the host once, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import model as M
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 s_max: int = 256):
        self.cfg = M.check_servable(cfg)
        self.params = params
        self.slots = slots
        self.s_max = s_max
        self.device = params["embed"].device
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.lengths = np.zeros((slots,), np.int64)
        self.budget = np.zeros((slots,), np.int64)
        self.caches = M.init_caches(cfg, slots, s_max, device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long,
                                  device=self.device)
        self.completed: List[Request] = []

    def submit(self, req: Request):
        """Queue ``req``; ``ValueError`` for a prompt longer than ``s_max``
        or one the recurrent layers' chunked scans refuse."""
        if len(req.prompt) > self.s_max:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds "
                             f"s_max={self.s_max}")
        M.check_prompt_length(self.cfg, len(req.prompt))
        self.queue.append(req)

    def _prefill1(self, prompt: np.ndarray):
        tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                                 device=self.device)
        return M.prefill(self.cfg, self.params, {"tokens": tokens})

    def _decode(self, tokens, caches):
        return M.decode_step(self.cfg, self.params, tokens, caches)

    def _splice(self, slot: int, req: Request):
        """Prefill the prompt with batch 1 and write it into the slot's
        rows of every layer's cache."""
        logits, raw, _ = self._prefill1(req.prompt)
        S = len(req.prompt)
        for kind, c, new in zip(M.layer_kinds(self.cfg), self.caches, raw):
            mixer = M.parse_kind(kind)[0]
            if mixer == "attn":
                for buf, rows in ((c.k, new[0]), (c.v, new[1])):
                    buf[slot, S:].zero_()
                    buf[slot, :S] = rows[0].to(buf.dtype)
                c.length[slot] = S
                continue
            pairs = (zip(c, new) if mixer == "mamba" else
                     [*zip(c["tmix"], new["tmix"]), (c["cmix"], new["cmix"])])
            for buf, state in pairs:
                buf[slot] = state[0].to(buf.dtype)
        nxt = int(torch.argmax(logits[0, -1]))
        self.tokens[slot, 0] = nxt
        req.out_tokens.append(nxt)
        self.lengths[slot] = S
        self.budget[slot] = req.max_new_tokens - 1
        self.active[slot] = req

    def _refill(self):
        for slot in range(self.slots):
            if slot not in self.active and self.queue:
                self._splice(slot, self.queue.pop(0))

    def step(self) -> int:
        """One decode tick for all slots; returns #active."""
        self._refill()
        if not self.active:
            return 0
        logits, self.caches = self._decode(self.tokens, self.caches)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        self.tokens = nxt[:, None]
        nxt_np = nxt.cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt_np[slot])
            req.out_tokens.append(tok)
            self.budget[slot] -= 1
            self.lengths[slot] += 1
            done = (self.budget[slot] <= 0
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.lengths[slot] >= self.s_max - 1)
            if done:
                self.completed.append(req)
                del self.active[slot]
        return len(self.active)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed
