"""The dense decoder: ``num_layers`` layers, each h += attn(rmsnorm_ln1(h));
h += mlp(rmsnorm_ln2(h)), the MLP as ``act`` says."""
from portbench import work


def layer(ref, p, h):
    h = h + ref.attention(p["attn"], ref.rms(h, p["ln1"]["scale"]))
    return h + ref.mlp(p["mlp"], ref.rms(h, p["ln2"]["scale"]))


def body(ref, tree, h):
    for i in range(ref.m["num_layers"]):
        h = ref.remat(layer, ref, tree["layers"][str(i)], h)
    return h


def forward_products(m, B, S):
    D = m["d_model"]
    per = work.attention_products(m, B, S, D) + work.mlp_products(m, B * S, D, D)
    return m["num_layers"] * per
