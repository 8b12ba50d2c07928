#!/usr/bin/env python3
"""Which Gloo collectives take CUDA tensors: two ranks sharing one NVIDIA
GPU over Gloo (a FileStore rendezvous in a temporary directory), each
collective called with card tensors of 280 KB (the (K, d+1) stats at
K = 1000, d = 69).

    python3 scripts/gloo_cuda_probe.py

The port's collectives (``repro_torch.core.distributed``) stage card
tensors through pinned host memory on Gloo whatever this prints; the
probe says which of them would not have to.  For each collective it
prints whether it ran, and if it did, whether its result is right and
its median wall time over 20 calls (host clock ending in a sync); beside
it the staged all_gather the port runs.  Prints the card's name and
power limit first.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import datetime
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ELEMS = 1000 * 70
CALLS = 20


def _timed(torch, fn):
    times = []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rank(rank, tmp):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    t = torch.full((ELEMS,), float(rank + 1), device="cuda")
    want = torch.tensor([1.0, 2.0])

    def all_gather():
        bufs = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(bufs, t)
        return torch.stack([b[0] for b in bufs]).cpu()

    def broadcast():
        b = t.clone()
        dist.broadcast(b, src=0)
        return torch.tensor([b[0].item(), 2.0])

    def all_reduce():
        b = t.clone()
        dist.all_reduce(b)
        return torch.tensor([b[0].item() - 2.0, 2.0])

    def staged_all_gather():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        bufs = [torch.empty_like(host) for _ in range(2)]
        dist.all_gather(bufs, host)
        return torch.stack([b[0] for b in bufs]).to(t.device).cpu()

    out = {}
    for name, fn in (("all_gather", all_gather), ("broadcast", broadcast),
                     ("all_reduce", all_reduce),
                     ("staged all_gather (the port's)", staged_all_gather)):
        try:
            ok = bool(torch.equal(fn(), want))
            out[name] = {"runs": True, "right": ok,
                         "median_s": _timed(torch, fn)}
        except (RuntimeError, ValueError) as e:
            out[name] = {"runs": False, "error": str(e).splitlines()[0]}
        dist.barrier()
    if rank == 0:
        (Path(tmp) / "out.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(tmp,), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                print("gloo_cuda_probe: timed out", file=sys.stderr)
                return 1
        out = json.loads((Path(tmp) / "out.json").read_text())
    for name, res in out.items():
        print(f"{name}: {res}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
