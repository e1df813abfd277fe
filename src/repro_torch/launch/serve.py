"""Serving entry point: batched generation through the port's ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 --gen-len 32

Runs the reduced config of ``--arch`` (any arch of the registry, the moe
ones included) on seeded random weights, on the card unless ``--device
cpu`` is given. As in the JAX engine, the vlm and encdec
archs decode from the tokens alone: no patches, and whisper's cross caches
stay zero (the encoder does not run).
"""
import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine

    cfg = reduced(get_arch(args.arch).model).replace(
        param_dtype="float32", compute_dtype="float32")
    params = T.init_lm(cfg, 0, device=args.device)
    eng = ServingEngine(cfg, params, max_len=args.prompt_len + args.gen_len + 1,
                        device=args.device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    res = eng.generate(prompts, args.gen_len, temperature=args.temperature)
    print(f"arch={args.arch} prefill={res.prefill_s:.2f}s "
          f"decode={res.decode_s:.2f}s ({res.tokens_per_s:.1f} tok/s)")
    print("first request tokens:", res.tokens[0][:16])


if __name__ == "__main__":
    main()
