"""The pure Mamba2 stack: ``num_layers`` layers, each h += ssm(rmsnorm_ln(h))."""
from portbench import work


def layer(ref, p, h):
    return h + ref.ssm(p["ssm"], ref.rms(h, p["ln"]["scale"]))


def body(ref, tree, h):
    for i in range(ref.m["num_layers"]):
        h = ref.remat(layer, ref, tree["layers"][str(i)], h)
    return h


def forward_products(m, B, S):
    return m["num_layers"] * work.ssm_products(m, B, S)
