#!/usr/bin/env python3
"""Split-TF32 probe: the tensor-core assignment that the port set aside,
held against the port's plain version, f64 and the port's FP32 kernel on
one NVIDIA GPU.

    python3 scripts/split_tf32_probe.py

Builds scripts/split_tf32_probe.cu with nvcc into build/ (git-ignored),
then on the USCensus1990 shape (2,458,285 x 69) with K = 1000:

1. the fused fit of chip_smoke.py phase 5 (same seed), whose final
   centroids are the ones phase 5 checks predict against;
2. min distances of the split-TF32 kernel and of the port's assignment
   kernel against the plain version, |d - d_plain| / max(d_plain, 1), on
   predict's full chunk, its padded tail chunk and all rows (chip_smoke.py
   accepts 1e-5), and the rows whose labels differ;
3. both against f64 on a 2% subset, centroids after five f64 Lloyd
   steps: error of the min distance over max(|x|^2, 1) (median, p99.9,
   max) and labels that differ from the f64 argmin;
4. CUDA-event times of both at predict's chunk and at all rows.

Prints the card's name and power limit first.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("split_tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import AAKMeans
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels.tiles import pad_rows

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out = build.BUILD_ROOT / "probe" / "libsplit_tf32_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(out), str(ROOT / "scripts" /
                                        "split_tf32_probe.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_launch.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.probe_launch.restype = ctypes.c_int
    lib.probe_scratch_floats.argtypes = [i, i]
    lib.probe_scratch_floats.restype = ctypes.c_longlong
    dev = torch.device("cuda")

    def split_tf32(x, c):
        n, d = x.shape
        k = c.shape[0]
        labels = torch.empty(n, dtype=torch.int32, device=dev)
        mind = torch.empty(n, dtype=torch.float32, device=dev)
        scratch = torch.empty(lib.probe_scratch_floats(k, d), device=dev)
        rc = lib.probe_launch(x.data_ptr(), c.data_ptr(), n, k, d,
                              scratch.data_ptr(), labels.data_ptr(),
                              mind.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        return labels, mind

    def event_ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    kernels = {"split-TF32": split_tf32, "FP32 (the port)": A.assignment}
    x = torch.from_numpy(make_dataset("USCensus1990")).to(dev)
    n = x.shape[0]
    model = AAKMeans(n_clusters=1000, backend="fused", n_init=1).fit(x)
    c = model.centroids_
    print(f"fused fit: n_iter_ {model.n_iter_}, inertia_ {model.inertia_!r}")
    tail = n % PREDICT_CHUNK
    shapes = {"predict's full chunk": x[:PREDICT_CHUNK],
              "predict's tail chunk": pad_rows(x[n - tail:], PREDICT_CHUNK),
              "all rows": x}
    for what, xs in shapes.items():
        lab_p, d_p = A.assignment_plain(xs, c)
        for name, fn in kernels.items():
            lab, d = fn(xs, c)
            rel = float(((d - d_p).abs() / d_p.abs().clamp_min(1.0)).max())
            print(f"{name} vs plain, {what}: min distance {rel:.3e} of "
                  f"max(d, 1); labels differ on {int((lab != lab_p).sum())}"
                  f" rows")

    xs = torch.from_numpy(make_dataset("USCensus1990", scale=0.02)).to(dev)
    x64 = xs.double()
    g = torch.Generator(device=dev).manual_seed(0)
    c64 = x64[torch.randperm(xs.shape[0], generator=g, device=dev)[:1000]]
    for _ in range(5):
        lab = torch.cdist(x64, c64).argmin(dim=1)
        s = torch.zeros_like(c64).index_add_(0, lab, x64)
        cnt = torch.bincount(lab, minlength=1000).double()
        c64 = torch.where(cnt[:, None] > 0, s / cnt.clamp_min(1)[:, None],
                          c64)
    c32 = c64.float()
    c64 = c32.double()
    d64 = (torch.sum(x64 * x64, 1, keepdim=True) - 2.0 * x64 @ c64.T
           + torch.sum(c64 * c64, 1)).clamp_min(0.0)
    m64, l64 = d64.min(dim=1)
    scale = torch.sum(x64 * x64, dim=1).clamp_min(1.0)
    for name, fn in {**kernels, "plain": A.assignment_plain}.items():
        lab, d = fn(xs, c32)
        err = ((d.double() - m64).abs() / scale).float().cpu()
        q = torch.quantile(err, torch.tensor([0.5, 0.999])).tolist()
        print(f"{name} vs f64 ({xs.shape[0]} rows): error over "
              f"max(|x|^2, 1) median {q[0]:.3e}, p99.9 {q[1]:.3e}, max "
              f"{float(err.max()):.3e}; labels differ on "
              f"{int((lab.long() != l64).sum())} rows")

    chunk = x[:PREDICT_CHUNK]
    for name, fn in kernels.items():
        print(f"{name}: predict's chunk {event_ms(lambda: fn(chunk, c), 50)!r}"
              f" ms, all rows {event_ms(lambda: fn(x, c), 5)!r} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
