"""Serve a small LM of the port with batched requests: prefill through the
one-token decode path to fill the caches, then batched greedy decode steps.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch mamba2-370m] [--device cpu]

Port of ``examples/serve_lm.py`` with its flags and defaults, and
``--device`` (the card unless ``cpu`` is given). The prompts are seeded
torch integers, not ``jax.random``'s; every host clock read waits for the
card first.
"""
import argparse
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import torch

    from repro_torch import device as dev
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as T

    device = dev.resolve(args.device)
    spec = get_arch(args.arch)
    cfg = reduced(spec.model).replace(param_dtype="float32",
                                      compute_dtype="float32")
    params = T.init_lm(cfg, 0, device=device)
    max_len = args.prompt_len + args.gen_len
    caches = T.init_caches(cfg, args.batch, max_len, torch.float32,
                           device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(device)

    def clock():
        dev.synchronize(device)
        return time.perf_counter()

    with torch.inference_mode():
        # prefill: feed prompt tokens through the decode path to fill caches
        t0 = clock()
        for i in range(args.prompt_len):
            logits, caches = T.apply_lm_decode(params, cfg, prompts[:, i:i + 1],
                                               caches, i)
        prefill_s = clock() - t0

        # batched greedy decode
        tok = logits[:, -1].argmax(-1)[:, None]
        out = [tok]
        t0 = clock()
        for i in range(args.prompt_len, max_len - 1):
            logits, caches = T.apply_lm_decode(params, cfg, tok, caches, i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        decode_s = clock() - t0
    gen = torch.cat(out, dim=1)

    tps = args.batch * gen.shape[1] / decode_s
    print(f"arch={args.arch} family={cfg.family}")
    print(f"prefill: {args.prompt_len} toks x {args.batch} reqs "
          f"in {prefill_s:.2f}s")
    print(f"decode:  {gen.shape[1]} toks x {args.batch} reqs "
          f"in {decode_s:.2f}s ({tps:.1f} tok/s)")
    print("sample token ids:", gen[0, :12].tolist())
    return gen


if __name__ == "__main__":
    main()
