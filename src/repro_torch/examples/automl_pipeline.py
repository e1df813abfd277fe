"""AutoML workflow of the port (paper App. F and §IV.C): LLM hyperparameter
tuning (Data Card + Model Card -> predicted logs -> pick), then REAL
concurrent training of the chosen config and a baseline, model selection
through couler.

    PYTHONPATH=src python -m repro_torch.examples.automl_pipeline [--device cpu]

Port of ``examples/automl_pipeline.py``; the two train steps run the port's
``train_real_model`` on ``--device`` (the card unless ``cpu`` is given).
"""
import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from repro_torch import device as dev
    from repro_torch.core import couler
    from repro_torch.core.autotune import (DataCard, ModelCard,
                                           train_real_model, tune)
    from repro_torch.core.engines.local import LocalEngine

    device = str(dev.resolve(args.device))
    dc = DataCard("synthetic-lm", input_type="text", label_space="tokens",
                  eval_metric="loss", n_examples=50_000, seq_len=32)
    mc = ModelCard("tiny-lm", structure="decoder-transformer",
                   n_params=600_000)
    print("Algorithm 4: predicting training logs over the search space ...")
    ours = tune(dc, mc).best
    baseline = {"learning_rate": 1e-4, "batch_size": 64, "weight_decay": 0.0}
    print("  HP:Ours      =", ours)
    print("  HP-baseline1 =", baseline)

    with couler.workflow("automl") as ir:
        outs = couler.concurrent([
            lambda: couler.run_step(train_real_model, ours, device=device,
                                    step_name="train-ours", est_time_s=30),
            lambda: couler.run_step(train_real_model, baseline, device=device,
                                    step_name="train-baseline", est_time_s=30),
        ])
        couler.run_step(
            lambda a, b: {"winner": "ours" if a["final_loss"] < b["final_loss"]
                          else "baseline",
                          "ours": a["final_loss"], "baseline": b["final_loss"]},
            outs[0], outs[1], step_name="select")
    eng = LocalEngine(max_workers=2, enable_speculation=False)
    try:
        run = eng.submit(ir)
    finally:
        eng.close()
    print("workflow:", run.status)
    print("result:", run.artifacts["select:out"])
    return run


if __name__ == "__main__":
    main()
