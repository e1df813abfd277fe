"""Tiny copies of the cells, for the CPU tests: the same families, layer
pattern, step and traffic shape, at widths a test run holds."""
from __future__ import annotations

import copy

from portbench import harness

WIDTHS = {
    "stablelm-1.6b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                          d_ff=128, vocab_size=500, pad_vocab_multiple=16),
    # two groups of two mamba2 layers, then one leftover: the shared block twice
    "zamba2-1.2b": dict(num_layers=5, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                        d_ff=128, vocab_size=500, pad_vocab_multiple=16, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16, shared_attn_interval=2),
}


def cell(name: str, dtype: str = "float32", seq: int = 64, accum: int = 1,
         **keys) -> harness.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` at tiny widths in ``dtype``, with
    micro-batches of 2 sequences of ``seq``, ``accum`` of them a step; the
    configuration's other keys as ``keys`` sets them (``family="ssm"``,
    ``act="gelu"``)."""
    c = harness.load_cell(name)
    c.config = copy.deepcopy(c.config)
    model = c.config["model"]
    model.update(WIDTHS[model["name"]], param_dtype=dtype, compute_dtype=dtype, **keys)
    c.traffic = dict(c.traffic, seq=seq, micro_batch=2, accum_steps=accum, trace_steps=2)
    return c
