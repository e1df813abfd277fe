"""Whether gloo takes CUDA tensors for the collectives the port uses.

    PYTHONPATH=src python scripts/probe_gloo_cuda.py

For each of all_to_all_single, all_gather_into_tensor, reduce_scatter_tensor,
a MAX all_reduce and a send/recv pair, on int8 and on float32, two fresh
gloo ranks on one card run it once on CUDA tensors and check the result,
so a rank that dies takes only its own case with it. Prints one JSON line:
each case's answer (true, "wrong result", the error, or the exit code of a
rank that died), the card line and torch's version.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
OPS = ("all_to_all_single", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_reduce_max", "send_recv")
DTYPES = ("int8", "float32")


def _case(op, x, rank):
    dt, dev = x.dtype, x.device
    if op == "all_to_all_single":
        o = torch.empty_like(x)
        dist.all_to_all_single(o, x)
        want = [0, 1, 4, 5] if rank == 0 else [2, 3, 6, 7]
    elif op == "all_gather_into_tensor":
        o = torch.empty(8, dtype=dt, device=dev)
        dist.all_gather_into_tensor(o, x)
        want = list(range(8))
    elif op == "reduce_scatter_tensor":
        o = torch.empty(2, dtype=dt, device=dev)
        dist.reduce_scatter_tensor(o, x)
        want = [4 + 2 * (2 * rank + i) for i in range(2)]
    elif op == "all_reduce_max":
        o = x.clone()
        dist.all_reduce(o, op=dist.ReduceOp.MAX)
        want = [4, 5, 6, 7]
    else:
        o = torch.empty_like(x)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                         dist.P2POp(dist.irecv, o, 1 - rank)]):
            r.wait()
        want = [4 * (1 - rank) + i for i in range(4)]
    return o.is_cuda and o.cpu().tolist() == want


def _rank(rank, store, out, op, dtype):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    x = (torch.arange(4) + 4 * rank).to(getattr(torch, dtype)).to("cuda:0")
    try:
        res = True if _case(op, x, rank) else "wrong result"
    except Exception as e:                  # the answer is the error itself
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _one(op, dtype) -> None:
    d = tempfile.mkdtemp()
    out = os.path.join(d, "res.json")
    mp.start_processes(_rank, args=(os.path.join(d, "store"), out, op, dtype),
                       nprocs=WORLD, join=True, start_method="spawn")
    print(open(out).read())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch import device as dev
    res = {}
    for op in OPS:
        for dtype in DTYPES:
            r = subprocess.run([sys.executable, __file__, "--one", op, dtype],
                               capture_output=True, text=True, timeout=180)
            lines = r.stdout.strip().splitlines()
            res[f"{op}/{dtype}"] = (json.loads(lines[-1]) if r.returncode == 0 and lines
                                    else f"a rank died (exit {r.returncode}): "
                                         + (r.stderr.strip().splitlines() or [""])[0][:160])
    print(json.dumps({"gloo_cuda": res, "all": all(v is True for v in res.values()),
                      "card": dev.card_line(), "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        _one(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
