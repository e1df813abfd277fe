"""Batched serving engine: cache-backed prefill + greedy/temperature decode.

Port of ``repro/serving/engine.py`` with the same semantics: the prompt is
prefilled through the one-token decode path, greedy decoding takes the
argmax, and caches are float32 unless asked otherwise. Temperature
sampling draws from ``softmax(logits / T)`` as JAX's ``categorical`` does,
with a ``torch.Generator`` seeded per call: other samples than
``jax.random`` gives from the same seed, from the same distribution (the
softmax in fp32 whatever the logits' type). Every host time read
waits for the card first. Every family runs through ``init_caches`` and
``apply_lm_decode`` (moe with MLA's latent caches for deepseek, its MoE
capacity from each step's own B tokens); as in the JAX engine, the vlm
family decodes without its patches and the encdec family with zero cross
caches, because the engine never runs the encoder.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch import device as dev
from repro_torch.models import transformer as T


@dataclass
class GenerationResult:
    tokens: list
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def sample(last: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens: the argmax at temperature 0, else
    one draw a row from ``softmax(last / temperature)``."""
    if temperature <= 0:
        return last.argmax(dim=-1, keepdim=True)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


class ServingEngine:
    def __init__(self, cfg, params, *, max_len: int = 512,
                 cache_dtype=torch.float32, device: dev.DeviceLike = "cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = dev.resolve(device)

    def _clock(self) -> float:
        dev.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def generate(self, prompts, gen_len: int, temperature: float = 0.0,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, P) int token batch -> greedy/temperature decode."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, P = prompts.shape
        if P + gen_len > self.max_len:
            raise ValueError(f"prompt {P} + gen_len {gen_len} exceeds "
                             f"max_len {self.max_len}")
        caches = T.init_caches(self.cfg, B, self.max_len, self.cache_dtype,
                               device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = self._clock()
        logits = None
        for i in range(P):                      # prefill via the decode path
            logits, caches = T.apply_lm_decode(self.params, self.cfg,
                                               prompts[:, i:i + 1], caches, i)
        prefill_s = self._clock() - t0

        t0 = self._clock()
        tok = sample(logits[:, -1], temperature, gen)
        out = [tok]
        for i in range(P, P + gen_len - 1):
            logits, caches = T.apply_lm_decode(self.params, self.cfg, tok,
                                               caches, i)
            tok = sample(logits[:, -1], temperature, gen)
            out.append(tok)
        gen_tokens = torch.cat(out, dim=1)
        decode_s = self._clock() - t0
        return GenerationResult(
            tokens=gen_tokens.tolist(), prefill_s=prefill_s, decode_s=decode_s,
            tokens_per_s=B * gen_tokens.shape[1] / max(decode_s, 1e-9))
