#!/usr/bin/env python3
"""Fused-step probe: the port's two-pass fused step against the one-pass
design it set aside, and the bounded step's cases, on one NVIDIA GPU at
the main path's shape (USCensus1990, 2,458,285 x 69, K = 1000).

    python3 scripts/fused_gather_probe.py

Builds scripts/fused_gather_probe.cu with nvcc into build/ (git-ignored;
it prints ptxas's register and spill report), fits K = 1000 with the fused
engine from chip_smoke.py's seed, then the cluster-ordered fused_bounds run
of chip_smoke.py phase 5b, and times with CUDA events, in turns, on the
final centroids:

1. fused_lloyd (the port: the sweep, then the update kernel's segment
   sum), and the one-pass kernel of the probe's source: whole (mode 0),
   without its stats gather (mode 1) and the gather alone on the step's
   labels (mode 2);
2. the pallas pair: the assignment at all rows plus the update;
3. fused_bounds at gs 512 (G = 2) and gs 64 (G = 16) with nothing to skip,
   and on the ordered run's last bounds;
4. the device time of each kernel of a fused and of those bounded steps,
   from torch.profiler (five steps each).

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
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import AAKMeans, get_backend
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.data.synthetic import dataset_components, make_dataset
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U

    print(cs.nvidia_smi_line(), flush=True)
    out = build.BUILD_ROOT / "probe" / "libfused_gather_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out), str(ROOT / "scripts" / "fused_gather_probe.cu")],
        check=True, capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "probe_step" in line or "spill" in line or "registers" in line:
            print("  " + line.strip())
    build.build()
    for name in ("fused_lloyd", "fused_bounds"):
        print(f"  {name}:")
        text = build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "spill" in line or "registers" in line or "Compiling" in line:
                print("    " + line.strip())
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_launch.argtypes = [i, p, p, p, i, i, i, i, p, p, p, p, p, p]
    lib.probe_launch.restype = ctypes.c_int
    lib.probe_scratch_floats.argtypes = [i, i]
    lib.probe_scratch_floats.restype = ctypes.c_longlong

    dev = torch.device("cuda")
    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    n, d = x.shape
    k = cs.MAIN_K
    model = AAKMeans(n_clusters=k, backend="fused", n_init=1).fit(x)
    c = model.centroids_
    print(f"fused fit: n_iter_ {model.n_iter_}, n_accepted_ "
          f"{model.n_accepted_}, inertia_ {model.inertia_!r}", flush=True)
    labels0 = F.fused_lloyd(x, c)[0]

    slabs = min(264, -(-n // 64))     # two blocks on each of 132 SMs
    lab = torch.empty(n, dtype=torch.int32, device=dev)
    mind = torch.empty(n, device=dev)
    part = torch.empty(slabs * k * (d + 1), device=dev)
    part_e = torch.empty(slabs, device=dev)
    scratch = torch.empty(lib.probe_scratch_floats(k, d), device=dev)

    def probe(mode):
        rc = lib.probe_launch(mode, x.data_ptr(), c.data_ptr(),
                              labels0.data_ptr(), n, k, d, slabs,
                              scratch.data_ptr(), lab.data_ptr(),
                              mind.data_ptr(), part.data_ptr(),
                              part_e.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")

    probe(0)
    want = F.fused_lloyd(x, c)
    print(f"one-pass labels equal the port's: "
          f"{torch.equal(lab, want[0])}, distances "
          f"{torch.equal(mind, want[1])}")

    # the ordered run of chip_smoke.py phase 5b, for its last bounds
    order = torch.from_numpy(np.argsort(dataset_components(cs.MAIN_N_NAME),
                                        kind="stable")).to(dev)
    x_ord = x[order].contiguous()
    del order
    seeds = x_ord[torch.linspace(0, n - 1, k, device=dev).long()][None]
    rec = cs.StepRecorder(get_backend("fused_bounds",
                                      group_size=cs.ORDERED_GS))
    gs_o = engine_group_size(k, cs.ORDERED_GS)
    AAKMeans(n_clusters=k, backend=rec.backend, n_init=1).fit(
        x_ord, c0s=seeds)
    cs_last, carry_last = rec.last
    bnds_o = squared_bounds(carry_last, cs_last, k, gs_o)
    del rec, carry_last
    gs_main = engine_group_size(k)

    def init_bounds(gs):
        return squared_bounds(bounds.init_carry(x, c[None], k, gs), c[None],
                              k, gs)

    b2, b16 = init_bounds(gs_main), init_bounds(gs_o)
    runs = {
        "fused_lloyd": lambda i: F.fused_lloyd(x, c),
        "one-pass 0 (sweep + gather)": lambda i: probe(0),
        "one-pass 1 (sweep only)": lambda i: probe(1),
        "one-pass 2 (gather only)": lambda i: probe(2),
        "assignment, all rows": lambda i: A.assignment(x, c[None]),
        "update": lambda i: U.update(x, labels0, k),
        f"fused_bounds gs {gs_main}, skip 0": lambda i: F.fused_lloyd(
            x, c[None], bounds=b2, gs=gs_main),
        f"fused_bounds gs {gs_o}, skip 0": lambda i: F.fused_lloyd(
            x, c[None], bounds=b16, gs=gs_o),
        f"fused_bounds gs {gs_o}, ordered last step": lambda i: F.fused_lloyd(
            x_ord, cs_last, bounds=bnds_o, gs=gs_o),
    }
    skip = float(F.fused_lloyd(x_ord, cs_last, bounds=bnds_o, gs=gs_o)[6][0])
    print(f"ordered last step skips {skip!r}")
    times = {name: [] for name in runs}
    for turn in range(2):
        names = list(runs) if turn == 0 else list(reversed(runs))
        for name in names:
            times[name].append(cs.event_ms(torch, runs[name], 10))
    for name, ts in times.items():
        print(f"{name}: {ts[0]!r} ms, {ts[1]!r} ms")
    pair = [a + u for a, u in zip(times["assignment, all rows"],
                                  times["update"])]
    print(f"fused_lloyd over the pallas pair: "
          f"{[f / p for f, p in zip(times['fused_lloyd'], pair)]}")
    cuda = torch.profiler.ProfilerActivity.CUDA
    for name in ("fused_lloyd", f"fused_bounds gs {gs_main}, skip 0",
                 f"fused_bounds gs {gs_o}, ordered last step"):
        for i in range(3):
            runs[name](i)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[cuda]) as prof:
            for i in range(5):
                runs[name](i)
            torch.cuda.synchronize()
        print(f"{name}, device ms a step by kernel:")
        for ev in prof.key_averages():
            total = getattr(ev, "device_time_total", 0)
            if total > 0:
                print(f"  {ev.key[:70]}: {total / 5 / 1e3!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
