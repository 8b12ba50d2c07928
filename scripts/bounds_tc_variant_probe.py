#!/usr/bin/env python3
"""Epilogue probe of the bounded tensor-core sweep (csrc/sweep_tc.cuh,
``bounds_tc``): this checkout's bounded step beside copies of it whose
epilogue does less, each built from a copy of csrc, on one NVIDIA GPU.

    python3 scripts/bounds_tc_variant_probe.py [this,fold,no_closes,...]

Each variant is this checkout's csrc with one textual change:

- ``this``: unchanged;
- ``fold``: the fused step's epilogue (``fold``) in place of the bounded
  one: no group minima, so its time bounds from below what the bounded
  epilogue can cost (its outputs are not the bounded step's);
- ``no_closes``: the bounded epilogue without the group closes (the
  minima computed, never merged or written) and without the two-group
  pass, so ptxas has no reason to serialize the wgmma (C7520);
- ``masked``: the one-group pass always masked (no unmasked copy for a
  chunk that the tile computes whole);
- ``no_two_groups``: no two-group pass (such chunks take the two-pass
  form).

Each is built (fused_bounds.cu, nvcc, into build/repro_torch/probe/variants/,
git-ignored), its ptxas registers and C7520 remarks printed.  Then the
bf16 bounded step at USCensus1990 (2,458,285 x 69), K = 1000 (centroids
three Lloyd steps from random rows), from the initial carry (skip 0) at
the default groups (G = 2) and at gs 64 (G = 16), is timed with CUDA
events in turns (each variant in order, then in reverse), with the bf16
fused step in every turn.  Prints the card's name and power limit first;
exits non-zero without a CUDA device or when a build fails.
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PATCHES = {
    "this": [],
    "fold": [("      fold_bounded(cross, c0);",
              "      fold(cross, cn + c0, c0, quad, xn, key, arg);")],
    "no_closes": [("      if (on) open_group(grp0);", ""),
                  ("    if (uniform(split + bd.gs / 8 >= 16)) {",
                   "    if (false) {")],
    "masked": [("      if (uniform(on == 0xffffu))\n        pass(false);\n"
                "      else\n        pass(true);", "      pass(true);")],
    "no_two_groups": [("    if (uniform(split + bd.gs / 8 >= 16)) {",
                       "    if (false) {")],
}


def main() -> int:
    names = (sys.argv[1] if len(sys.argv) > 1 else
             "this,fold,no_closes,masked,no_two_groups").split(",")
    import torch
    if not torch.cuda.is_available():
        print("bounds_tc_variant_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F

    print(cs.nvidia_smi_line(), flush=True)
    src = (build.CSRC / "sweep_tc.cuh").read_text()
    out_dir = build.BUILD_ROOT / "probe" / "variants"
    procs = {}
    for name in names:
        text = src
        for old, new in PATCHES[name]:
            if old not in text:
                print(f"variant {name}: the source no longer holds "
                      f"{old.strip()!r}", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        d = out_dir / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / "sweep_tc.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(d / "libfused_bounds.so"), str(d / "fused_bounds.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        regs = [r for f, r in re.findall(
            r"entry function '(\w+)'.*?Used (\d+) registers", log, re.S)
            if "bounds_tc" in f]
        print(f"{name}: bounds_tc registers (resident, streamed) {regs}, "
              f"C7520 remarks {log.count('C7520')}", flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / name / "libfused_bounds.so"))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    k = cs.MAIN_K
    c = x[torch.randperm(x.shape[0], generator=gen,
                         device=dev)[:k]][None].contiguous()
    for _ in range(3):
        out = F.fused_lloyd(x, c)
        c = torch.where(out[3][..., None] > 0,
                        out[2] / out[3][..., None].clamp_min(1.0), c)
    xb, cb = x.bfloat16(), c.bfloat16()
    for gs in (engine_group_size(k), 64):
        bnds = squared_bounds(bounds.init_carry(x, c, k, gs), c, k, gs)
        got = collections.defaultdict(list)
        for name in names + names[::-1]:
            build._loaded["fused_bounds"] = libs[name]
            got[name].append(cs.event_ms(
                torch, lambda i: F.fused_lloyd(xb, cb, bounds=bnds, gs=gs),
                10, warmup=2))
            got["the bf16 fused step"].append(cs.event_ms(
                torch, lambda i: F.fused_lloyd(xb, cb), 10, warmup=2))
        fused = sum(got["the bf16 fused step"]) / len(
            got["the bf16 fused step"])
        print(f"gs {gs} (G = {bnds[1].shape[-1]}), skip 0, ms in turns: "
              + "; ".join(f"{name} {sum(v) / len(v)!r} ({v}, "
                          f"{sum(v) / len(v) / fused!r}x the fused step)"
                          for name, v in got.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
