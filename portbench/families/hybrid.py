"""Zamba2 without its LoRA adapters: groups of ``shared_attn_interval``
Mamba2 layers (``families/ssm.py``'s layer), each group followed by the one
shared block over c = concat(h, e0), e0 the embedding:
h += attn(rmsnorm_ln1(c)) (from 2 d); h += mlp(rmsnorm_ln2(concat(h, e0)));
then the leftover Mamba2 layers after the last group."""
import torch

from portbench import work
from portbench.families import ssm


def shared_block(ref, p, h, e0):
    c = torch.cat([h, e0], dim=-1)
    h = h + ref.attention(p["attn"], ref.rms(c, p["ln1"]["scale"]))
    return h + ref.mlp(p["mlp"], ref.rms(torch.cat([h, e0], dim=-1), p["ln2"]["scale"]))


def body(ref, tree, h):
    m, e0 = ref.m, h
    k = m["shared_attn_interval"]
    for g in range(m["num_layers"] // k):
        for j in range(k):
            h = ref.remat(ssm.layer, ref, tree["groups"][str(g)][str(j)], h)
        h = ref.remat(shared_block, ref, tree["shared"], h, e0)
    for j in range(m["num_layers"] % k):
        h = ref.remat(ssm.layer, ref, tree["leftover"][str(j)], h)
    return h


def forward_products(m, B, S):
    Dc = 2 * m["d_model"]
    shared = work.attention_products(m, B, S, Dc) + work.mlp_products(m, B * S, Dc,
                                                                      m["d_model"])
    return (m["num_layers"] * work.ssm_products(m, B, S)
            + m["num_layers"] // m["shared_attn_interval"] * shared)
