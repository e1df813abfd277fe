"""The reference against the port on the CPU at tiny widths, in fp32: the
loss, every gradient and the parameters after one AdamW step, for the dense
(with each ``act``), the hybrid and the pure Mamba2 (``ssm``) model, with and
without accumulation."""
import pytest
import torch

from portbench import data, harness, tiny, weights
from portbench.reference import Reference

CASES = [("stablelm-1.6b.train-4k", 1, {}), ("stablelm-1.6b.train-4k", 2, {}),
         ("zamba2-1.2b.train-4k-b8", 1, {}), ("zamba2-1.2b.train-4k-b8", 2, {}),
         ("stablelm-1.6b.train-4k", 1, {"act": "gelu"}),
         ("stablelm-1.6b.train-4k", 2, {"act": "geglu"}),
         ("zamba2-1.2b.train-4k-b8", 1, {"family": "ssm"}),
         ("zamba2-1.2b.train-4k-b8", 2, {"family": "ssm"})]


@pytest.mark.parametrize("name,accum,keys", CASES)
def test_one_step_equals_the_port(name, accum, keys):
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.training import train as TR
    cell = tiny.cell(name, **keys)
    model, train = cell.config["model"], cell.config["train"]
    cfg, tcfg = ModelConfig(**model), TrainConfig(**{**train, "accum_steps": accum})
    cpu = torch.device("cpu")
    seed = 2 ** 31 + 99
    state = TR.init_train_state(cfg, tcfg, 0, device=cpu)
    params = dict(state["params"].named_parameters())
    leaves = weights.leaves_of(params.items())
    with torch.no_grad():
        for n, v in weights.draw(leaves, seed, cpu):
            params[n].copy_(v)
    batch = {k: torch.from_numpy(v) for k, v in
             data.batches(seed, 1, 2 * accum, cell.traffic["seq"], model["vocab_size"])[0].items()}

    ref = Reference(model, train)
    ref_params = {n: v.float().requires_grad_(True) for n, v in weights.draw(leaves, seed, cpu)}
    rows = 2
    micro = [slice(i * rows, (i + 1) * rows) for i in range(accum)]
    ref_loss = sum(ref.loss(ref_params, batch["tokens"][m], batch["targets"][m])
                   for m in micro) / accum
    ref_grads = dict(zip(ref_params, torch.autograd.grad(ref_loss, list(ref_params.values()))))
    loss, _ = TR.make_loss_fn(cfg, tcfg)(state["params"], batch) if accum == 1 else (None, None)
    if loss is not None:
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        torch.testing.assert_close(loss.detach(), ref_loss.detach(), rtol=1e-5, atol=1e-6)
        for n in params:
            torch.testing.assert_close(grads[n], ref_grads[n], rtol=1e-4, atol=1e-6)

    state, m = TR.make_train_step(cfg, tcfg)(state, batch)
    after = Reference(model, train).run(leaves, seed, [batch], accum, cpu, keep_params=True)
    assert abs(float(m["loss"]) - after["losses"][0]) <= 1e-5 * after["losses"][0]
    # AdamW moves an element by lr * g / (|g| + eps): where |g| is near eps
    # the step follows g's last bits, so an element may differ by a tenth of lr
    for n, p in params.items():
        torch.testing.assert_close(p.detach(), after["params"][n], rtol=1e-5,
                                   atol=0.1 * train["learning_rate"])


def test_check_steps_agree_through_the_harness():
    cell = tiny.cell("zamba2-1.2b.train-4k-b8")
    s = harness.first_steps(cell, 5, torch.device("cpu"))
    from portbench import check
    nums = check.numbers(s.got, harness.reference_run(cell, s, 5, torch.device("cpu")))
    assert max(nums.values()) < 1e-4
