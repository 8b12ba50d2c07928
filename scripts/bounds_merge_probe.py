#!/usr/bin/env python3
"""Group-minimum merge probe: the bounded kernel (csrc/fused_bounds.cu) as
the port builds it, which, where gs and K are multiples of 4, takes each
slot's group from its 4-centroid vector and merges a chunk that lies in
one group without masks, against a copy built with
-DREPRO_BOUNDS_GENERAL_MERGE, which takes the general masked per-group
merge at every group size, on one NVIDIA GPU at the main path's shape
(USCensus1990, 2,458,285 x 69, K = 1000).

    python3 scripts/bounds_merge_probe.py

Builds both libraries with nvcc into build/ (git-ignored; prints ptxas's
register and spill report of each), runs the cluster-ordered fused_bounds
fit of chip_smoke.py phase 5b for its last bounds, requires both builds
to give the same outputs bit for bit, then times with CUDA events, in
turns (port, general, general, port), fused_bounds at gs 512 (G = 2) and
gs 64 (G = 16) with nothing to skip, and on the ordered run's last step.

Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when the two builds disagree.
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
        print("bounds_merge_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import AAKMeans, get_backend
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.data.synthetic import dataset_components, make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F

    print(cs.nvidia_smi_line(), flush=True)
    build.build(["fused_bounds"])
    general = build.BUILD_ROOT / "probe" / "libfused_bounds_general.so"
    general.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DREPRO_BOUNDS_GENERAL_MERGE",
         "-o", str(general), str(build.CSRC / "fused_bounds.cu")],
        check=True, capture_output=True, text=True)
    port_log = build.library_path("fused_bounds").with_suffix(".log")
    for name, text in (("port", port_log.read_text()),
                       ("general", log.stdout + log.stderr)):
        print(f"  {name}:")
        for line in text.splitlines():
            if "bounds_tiles" in line or ("spill" in line and "0 bytes" not in
                                          line):
                print("    " + line.strip())
    libs = {"port": build.load("fused_bounds"),
            "general": ctypes.CDLL(str(general))}

    def use(name):
        build._loaded["fused_bounds"] = libs[name]

    dev = torch.device("cuda")
    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    n = x.shape[0]
    k = cs.MAIN_K
    gen = torch.Generator(device=dev).manual_seed(0)
    c = x[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()

    # the ordered run of chip_smoke.py phase 5b, for its last bounds
    order = torch.from_numpy(np.argsort(dataset_components(cs.MAIN_N_NAME),
                                        kind="stable")).to(dev)
    x_ord = x[order].contiguous()
    del order
    seeds = x_ord[torch.linspace(0, n - 1, k, device=dev).long()][None]
    rec = cs.StepRecorder(get_backend("fused_bounds",
                                      group_size=cs.ORDERED_GS))
    gs_o = engine_group_size(k, cs.ORDERED_GS)
    use("port")
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
    cases = {
        f"gs {gs_main}, skip 0": lambda i: F.fused_lloyd(
            x, c[None], bounds=b2, gs=gs_main),
        f"gs {gs_o}, skip 0": lambda i: F.fused_lloyd(
            x, c[None], bounds=b16, gs=gs_o),
        f"gs {gs_o}, ordered last step": lambda i: F.fused_lloyd(
            x_ord, cs_last, bounds=bnds_o, gs=gs_o),
    }
    same = True
    for name, fn in cases.items():
        outs = {}
        for lib in libs:
            use(lib)
            outs[lib] = [t.clone() for t in fn(0)]
        eq = all(torch.equal(a, b)
                 for a, b in zip(outs["port"], outs["general"]))
        same = same and eq
        print(f"{name}: skipped {float(outs['port'][6][0])!r}, the two "
              f"builds equal bit for bit {eq}", flush=True)
    times = {(case, lib): [] for case in cases for lib in libs}
    for order_libs in (("port", "general"), ("general", "port")):
        for lib in order_libs:
            use(lib)
            for case, fn in cases.items():
                times[(case, lib)].append(cs.event_ms(torch, fn, 10))
    for case in cases:
        port, gen_ = times[(case, "port")], times[(case, "general")]
        print(f"{case}: port {port!r} ms, general {gen_!r} ms, general / "
              f"port {sum(gen_) / sum(port)!r}")
    use("port")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
