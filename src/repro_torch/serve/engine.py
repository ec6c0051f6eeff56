"""Batched serving engine: continuous batching over a fixed slot pool.

The engine owns a cache of ``slots`` rows on its device: a (slots,
max_seq) KV cache, the SSM cache's conv tail and float32 state per slot,
or both (hybrid), each with layers in front (``model.init_cache``).
Requests queue up; free slots are prefilled (one prefill per admission,
right-padded to a bucket length), then all active slots advance together
through one decode step with per-slot positions. Finished slots (EOS or
length limit) free immediately and the next queued request is admitted.

The behaviour is the JAX package's ``repro.serve.engine``: the prefill's
logits are discarded and the last prompt token is decoded again at
position ``plen - 1``, which for a KV cache rewrites that entry. For a
model that carries SSM state the port differs, because the JAX engine's
admission is wrong there (its tokens are not the model's): the padding
advances the state and fills the conv tail, the decode of the last prompt
token takes it into the state a second time, and the prefill convolves
after the previous request's conv tail. The port zeroes the slot's SSM
rows before the prefill and passes it the valid length ``plen - 1``: the
state stops there and the conv tail ends there, so the decode at
``plen - 1`` takes the last prompt token in once, and the tokens are the
model's greedy continuation. KV caches are admitted as before. An MoE
model is admitted as the JAX package's: its pad tokens are routed too, and
take expert capacity (``capacity_factor``) from the prompt's tokens. The
encdec family is not served here, as in the JAX package.

Caches are updated in place. Greedy (argmax) or temperature sampling
from a seeded ``torch.Generator``, whose draws differ from
``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M


@dataclasses.dataclass
class ServeConfig:
    slots: int = 8
    max_seq: int = 1024
    eos_id: int = 1
    temperature: float = 0.0
    prefill_bucket: int = 128
    max_new_tokens: int = 64


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int | None = None


class ServingEngine:
    def __init__(self, params, cfg: M.ModelConfig, scfg: ServeConfig,
                 device=None, generator: torch.Generator | None = None):
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the engine serves decoder-only "
                             "models (the JAX package's too); an encdec model "
                             "serves through encode and decode_step(enc_out=)")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.cache = M.init_cache(cfg, scfg.slots, scfg.max_seq, self.device)
        self.pos = np.zeros(scfg.slots, np.int32)          # next position
        self.active = np.zeros(scfg.slots, bool)
        self.last_tok = np.zeros(scfg.slots, np.int32)
        self.budget = np.zeros(scfg.slots, np.int32)
        self.uid = [-1] * scfg.slots
        self.out: dict[int, list[int]] = {}
        self.queue: deque[Request] = deque()
        self.generator = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(0)

    # -------------------------------------------------------- internals
    def _decode(self, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Advance every slot one token (positions vary per slot)."""
        cfg, params = self.cfg, self.params
        x = L.embed(params["embed"], toks[:, None], cfg)
        x, _, self.cache = M._run_stack(
            params["layers"], x, cfg, positions=pos[:, None],
            local_flags=cfg.is_local_flags, caches=self.cache, cache_pos=pos)
        logits = M._logits(params, x[:, 0], cfg)
        logits[..., cfg.vocab_size:] = -1e9
        if self.scfg.temperature > 0:
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32)

    def _prefill(self, slot: int, toks: torch.Tensor,
                 valid_len: int) -> torch.Tensor:
        """Prefill one slot's rows of the cache in place from the first
        ``valid_len`` tokens of ``toks`` (the rest is padding, which only a
        KV cache takes in); the logits. The slot's SSM rows start from
        zero."""
        sub = M.map_cache(lambda c: c[:, slot:slot + 1], self.cache)
        for part in (sub if type(sub) is tuple else (sub,)):
            if isinstance(part, L.SSMCache):
                part.conv.zero_()
                part.state.zero_()
        logits, _ = M.prefill(self.params, {"tokens": toks}, self.cfg, sub,
                              valid_len=valid_len)
        return logits

    # ------------------------------------------------------- public API
    def submit(self, req: Request):
        self.queue.append(req)
        self.out[req.uid] = []

    def _admit(self):
        for slot in range(self.scfg.slots):
            if self.active[slot] or not self.queue:
                continue
            req = self.queue.popleft()
            plen = len(req.prompt)
            bucket = min(self.scfg.max_seq,
                         max(self.scfg.prefill_bucket,
                             1 << (plen - 1).bit_length()))
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :plen] = req.prompt
            # the logits of the padded bucket's last position are not the
            # prompt's: they are discarded, and the prompt's last token is
            # decoded at plen - 1 (again for a KV cache, which it rewrites;
            # for the first time for the SSM state, stopped at plen - 1)
            self._prefill(slot, torch.from_numpy(toks).to(self.device),
                          plen - 1)
            self.active[slot] = True
            self.uid[slot] = req.uid
            self.budget[slot] = req.max_new_tokens or self.scfg.max_new_tokens
            self.last_tok[slot] = int(req.prompt[-1])
            self.pos[slot] = plen - 1

    def step(self) -> bool:
        """One engine tick: admit + one decode step for all slots."""
        self._admit()
        if not self.active.any():
            return False
        nxt = self._decode(torch.from_numpy(self.last_tok).to(self.device),
                           torch.from_numpy(self.pos).to(self.device))
        nxt = nxt.cpu().numpy()
        for slot in range(self.scfg.slots):
            if not self.active[slot]:
                continue
            tok = int(nxt[slot])
            self.out[self.uid[slot]].append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            self.budget[slot] -= 1
            if tok == self.scfg.eos_id or self.budget[slot] <= 0 \
                    or self.pos[slot] >= self.scfg.max_seq - 1:
                self.active[slot] = False
        return True

    def run_to_completion(self, max_ticks=10_000):
        ticks = 0
        while (self.queue or self.active.any()) and ticks < max_ticks:
            self.step()
            ticks += 1
        return {uid: toks for uid, toks in self.out.items()}
