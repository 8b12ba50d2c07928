"""Rank processes for the port's distributed tests (no JAX here).

The tests spawn ``python tests/torch_dist_ranks.py <case> <world> <rank>
<workdir>`` once per rank through ``run_ranks``.  The ranks meet through
a ``FileStore`` in ``workdir``, build a "cpu" ``DeviceMesh`` over Gloo,
read the test's inputs from ``workdir/inputs.npz`` (made with numpy from
a seed by the test), run the case and write what they found to
``workdir/out<rank>.pt``, which the test compares with the reference.
Every rank runs single-threaded; ``run_ranks`` kills the ranks when its
wall limit passes, so a hung rendezvous fails one test.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(case: str, world: int, inputs: dict, workdir,
              timeout: float = 120.0, **params) -> list:
    """Run ``case`` on ``world`` spawned Gloo ranks; -> each rank's
    output dict, in rank order.  ``params`` (ints, floats, strings)
    reach the case as ``inp["params"]``."""
    import torch
    workdir = Path(tempfile.mkdtemp(prefix=f"{case}{world}_", dir=workdir))
    np.savez(workdir / "inputs.npz", **inputs)
    torch.save(params, workdir / "params.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(workdir / f"log{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), case, str(world),
         str(r), str(workdir)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tails = "\n".join(
        f"--- rank {r} (rc {p.returncode}) ---\n"
        + (workdir / f"log{r}.txt").read_text()[-3000:]
        for r, p in enumerate(procs))
    if hung:
        raise TimeoutError(f"{case} at W={world} passed its {timeout} s "
                           f"limit\n{tails}")
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{case} at W={world} failed\n{tails}")
    return [torch.load(workdir / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# -- the rank side -------------------------------------------------------------

# the mesh's device type: "cpu", or "cuda" for the card tests
MESH_DEVICE = ["cpu"]


def _mesh(world: int, shape=None, names=("data",)):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(MESH_DEVICE[0], tuple(shape or (world,)),
                            mesh_dim_names=tuple(names))


def main(case: str, world: int, rank: int, workdir: str) -> None:
    """One rank: Gloo on the CPU unless the test's params ask for a
    process-group backend ("pg") and a mesh on "cuda" ("mesh_device"),
    where every rank computes on the current card."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    work = Path(workdir)
    params = torch.load(work / "params.pt")
    MESH_DEVICE[0] = params.get("mesh_device", "cpu")
    if MESH_DEVICE[0] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(str(work / "store"), world)
    pg = params.get("pg", "gloo")
    dist.init_process_group(
        pg, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=90),
        device_id=torch.device("cuda", torch.cuda.current_device())
        if pg == "nccl" else None)
    try:
        with np.load(work / "inputs.npz") as f:
            inp = {key: f[key] for key in f.files}
        inp["params"] = params
        out = CASES[case](rank, world, inp, work)
        torch.save(out, work / f"out{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


CASES: dict = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


@case
def steps(rank, world, inp, work):
    """Two steps of every registered engine through ``distribute`` on this
    rank's rows (at c, then at c2 on the first's carry: centroids that
    are the same bits at every world size); the batched step at R = 3
    with its collective count;
    the energy op; the collectives outside a scope; the compositions
    with the locality engine."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.backends import (backend_names, distribute,
                                           get_backend)
    from repro_torch.core.backends.bounds import extract_stats
    from repro_torch.core.locality import reorder_backend
    mesh = _mesh(world)
    x, c, c2, cs = (_t(inp[key]) for key in ("x", "c", "c2", "cs"))
    k = c.shape[0]
    xl = D.local_block(x, mesh, ("data",))
    out = {"names": [], "raised": {}}
    with D.mesh_scope(mesh):
        for name in backend_names():
            bk = distribute(get_backend(name), ("data",))
            res, carry = bk.step(xl, c, k, bk.init_carry(xl, c, k))
            res2, carry = bk.step(xl, c2, k, carry)
            st = extract_stats(carry)
            out["names"].append(name)
            out[name] = {"step": tuple(res), "step2": tuple(res2),
                         "stats": None if st is None else tuple(st),
                         "name": bk.name}
    if world == 1:
        # the undistributed steps in this process, for the bitwise test
        # (a product's blocking may follow the thread count)
        out["local"] = {}
        for name in backend_names():
            bk = get_backend(name)
            res, carry = bk.step(x, c, k, bk.init_carry(x, c, k))
            res2, _ = bk.step(x, c2, k, carry)
            out["local"][name] = (tuple(res), tuple(res2))
    with D.mesh_scope(mesh):
        # a batched step at R = 3 makes one collective
        dense = distribute(get_backend("dense"), ("data",))
        blocked = distribute(get_backend("blocked"), ("data",))
        D.reset_collective_counts()
        bres, _ = dense.batched_step(xl, cs, k, ())
        out["batched_dense"] = (tuple(bres), D.collective_counts())
        D.reset_collective_counts()
        bres, _ = blocked.batched_step(
            xl, cs, k, blocked.batched_init_carry(xl, cs, k))
        out["batched_blocked"] = (tuple(bres), D.collective_counts())
        # the derived energy reduces once
        lab = get_backend("dense").assign(xl, c).labels
        out["energy"] = dense.energy(xl, c, lab)
        out["converged"] = bool(dense.all_equal(lab, lab))
        # the legacy LloydOps whose update, energy and test reduce
        ops = D.distributed_lloyd_ops(("data",))
        c_new, ares = ops.g_map(xl, c, k)
        out["lloyd_ops"] = (c_new, ops.energy_fn(xl, c, ares.labels),
                            bool(ops.all_equal_fn(ares.labels, lab)),
                            ops.reduce_scalar(torch.ones(())))
    try:
        distribute(get_backend("dense"), ("data",)).energy(xl, c, lab)
    except RuntimeError as e:
        out["raised"]["outside"] = str(e)
    for what, fn in (
            ("double", lambda: distribute(dense, ("data",))),
            ("reorder_of_distributed",
             lambda: reorder_backend(distribute(get_backend("hamerly"),
                                                ("data",))))):
        try:
            fn()
        except ValueError as e:
            out["raised"][what] = str(e)
    wrapped = distribute(get_backend("hamerly_reorder"), ("data",))
    with D.mesh_scope(mesh):
        res, _ = wrapped.step(xl, c, k, wrapped.init_carry(xl, c, k))
    out["distribute_of_reorder"] = (wrapped.name, tuple(res))
    return out


@case
def solves(rank, world, inp, work):
    """``make_distributed_kmeans`` on dense and the fused engine's plain
    version, ``make_distributed_kmeans_batched(pick_best=True)`` at R = 3
    with the collectives of its trips, and the minibatch driver twice;
    ``shape``/``names``/``axes`` give the mesh."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.kmeans import KMeansConfig
    from repro_torch.core.minibatch import MiniBatchConfig
    from repro_torch.data.streaming import chunk_dataset
    p = inp["params"]
    mesh = _mesh(world, p.get("shape"), p.get("names", ("data",)))
    axes = tuple(p.get("axes", ("data",)))
    x, c0, cs = _t(inp["x"]), _t(inp["c0"]), _t(inp["cs"])
    k = c0.shape[0]
    cfg = KMeansConfig(k=k, max_iter=int(p.get("max_iter", 100)))
    out = {}
    for name in ("dense", "fused"):
        out[name] = tuple(D.make_distributed_kmeans(
            mesh, cfg, axes, backend=name)(x, c0))
    D.reset_collective_counts()
    best = D.make_distributed_kmeans_batched(
        mesh, cfg, axes, backend="dense", pick_best=True)(x, cs)
    out["batched"] = (tuple(best), D.collective_counts())
    mcfg = MiniBatchConfig(k=k, chunk_size=int(p["chunk"]), epochs=2)
    dc = chunk_dataset(x[int(p["val"]):], mcfg.chunk_size, mesh=mesh,
                       data_axes=axes)
    fit = D.make_distributed_kmeans_minibatch(mesh, mcfg, axes,
                                              backend="fused")
    runs = []
    for _ in range(2):
        D.reset_collective_counts()
        res = fit(dc.chunks, dc.weights, x[:int(p["val"])], c0,
                  torch.Generator().manual_seed(3))
        runs.append((tuple(res), D.collective_counts()))
    out["minibatch"] = runs
    if world == 1:
        # the undistributed solves in this process, for the bitwise tests
        from repro_torch.core.kmeans import (aa_kmeans, aa_kmeans_batched,
                                             aa_kmeans_minibatch,
                                             select_best)
        out["local"] = {name: tuple(aa_kmeans(x, c0, cfg, backend=name))
                        for name in ("dense", "fused")}
        out["local"]["batched"] = tuple(select_best(aa_kmeans_batched(
            x, cs, cfg, backend="dense")))
        dc = chunk_dataset(x[int(p["val"]):], mcfg.chunk_size)
        out["local"]["minibatch"] = tuple(aa_kmeans_minibatch(
            dc.chunks, dc.weights, x[:int(p["val"])], c0, mcfg,
            backend="fused", generator=torch.Generator().manual_seed(3),
            device="cpu"))
    return out


@case
def estimators(rank, world, inp, work):
    """Both estimators under the mesh: AAKMeans fit, predict, transform
    (exact and through a serving index) on rows that divide and on rows
    that do not, MiniBatchAAKMeans fit, the refusals, and save / load."""
    import torch.distributed as dist
    from repro_torch.core import AAKMeans, MiniBatchAAKMeans
    p = inp["params"]
    mesh = _mesh(world)
    x, k = inp["x"], int(p["k"])
    out = {}
    for what, rows in (("even", x), ("padded", x[:int(p["n_odd"])])):
        m = AAKMeans(n_clusters=k, backend=p["backend"], mesh=mesh,
                     seed=0, max_iter=int(p["max_iter"]))
        m.fit(rows)
        m.build_serving_index(n_candidates=4)
        out[what] = {
            "centroids": m.centroids_, "labels": m.labels_,
            "energy": m.energy_, "n_iter": m.n_iter_,
            "n_accepted": m.n_accepted_, "predict": m.predict(rows),
            "transform": m.transform(rows),
            "predict_approx": m.predict(rows, approx=True),
            "transform_approx": m.transform(rows, approx=True),
            "index": (m.closure_routers_, m.closure_candidates_)}
        if world == 1:
            # the single-device fit in this process, for the bitwise test
            one = AAKMeans(n_clusters=k, backend=p["backend"], seed=0,
                           max_iter=int(p["max_iter"]), device="cpu")
            one.fit(rows)
            out[what]["local"] = (one.centroids_, one.labels_, one.energy_,
                                  one.n_iter_, one.n_accepted_)
    path = work / "model.npz"
    if rank == 0:
        m.save(path)
    dist.barrier()
    loaded = AAKMeans.load(path, device="cpu")
    out["loaded"] = {"mesh": loaded.mesh, "data_axes": loaded.data_axes,
                     "predict": loaded.predict(rows)}
    mb = MiniBatchAAKMeans(n_clusters=k, chunk_size=int(p["chunk"]),
                           epochs=2, val_size=int(p["val"]),
                           backend=p["backend"], mesh=mesh, seed=1)
    mb.fit(x)
    out["minibatch"] = {"centroids": mb.centroids_, "energy": mb.energy_,
                        "n_steps": mb.n_steps_,
                        "n_accepted": mb.n_accepted_, "labels": mb.labels_}
    if world == 1:
        one = MiniBatchAAKMeans(n_clusters=k, chunk_size=int(p["chunk"]),
                                epochs=2, val_size=int(p["val"]),
                                backend=p["backend"], seed=1, device="cpu")
        one.fit(x)
        out["minibatch"]["local"] = (one.centroids_, one.energy_,
                                     one.n_steps_, one.n_accepted_)
    out["raised"] = {}
    for what, fn in (
            ("partial_fit", lambda: mb.partial_fit(x[:200])),
            ("hierarchical", lambda: AAKMeans(
                n_clusters=k, mesh=mesh, hierarchical=True).fit(x)),
            ("device", lambda: AAKMeans(n_clusters=k, mesh=mesh,
                                        device="cuda").fit(x))):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out["raised"][what] = (type(e).__name__, str(e))
    return out


@case
def resume(rank, world, inp, work):
    """Snapshots of ``make_distributed_kmeans``: ``write`` runs the
    uninterrupted segmented solve into ``run/`` (only the mesh's first
    rank writes) and resumes it from its first snapshot; ``from`` resumes
    the snapshot at ``path`` (another world size's, or the reference's)
    on ``backend``."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.kmeans import KMeansConfig
    p = inp["params"]
    mesh = _mesh(world, p.get("shape"), p.get("names", ("data",)))
    axes = tuple(p.get("axes", ("data",)))
    x, c0 = _t(inp["x"]), _t(inp["c0"])
    cfg = KMeansConfig(k=c0.shape[0], max_iter=int(p["max_iter"]))
    out = {}
    if p["mode"] == "write":
        run = work.parent / p["run_dir"]
        fit = D.make_distributed_kmeans(mesh, cfg, axes, backend=p["backend"],
                                        checkpoint_every=int(p["every"]),
                                        checkpoint_dir=run, sync_writes=True)
        out["whole"] = tuple(D.make_distributed_kmeans(
            mesh, cfg, axes, backend=p["backend"])(x, c0))
        out["segmented"] = tuple(fit(x, c0))
        first = run / f"it_{int(p['every']):08d}.npz"
        out["resumed"] = tuple(D.make_distributed_kmeans(
            mesh, cfg, axes, backend=p["backend"])(x, c0, resume_from=first))
        local, meta = D.restore_distributed_loop_state(
            first, x, c0, cfg, D.get_backend(p["backend"]), mesh, axes)
        out["restored_labels"] = local.labels
        out["meta"] = meta
        out["writes"] = D._writes(mesh)
    else:
        out["resumed"] = tuple(D.make_distributed_kmeans(
            mesh, cfg, axes, backend=p["backend"])(x, c0,
                                                   resume_from=p["path"]))
    return out


@case
def streamed(rank, world, inp, work):
    """``aa_kmeans_minibatch_streamed(mesh=)`` from a host array, twice,
    and the same stream without a mesh; ``chunk_dataset(mesh=)``'s local
    blocks."""
    import torch
    from repro_torch.core.kmeans import aa_kmeans_minibatch_streamed
    from repro_torch.core.minibatch import MiniBatchConfig
    from repro_torch.data.streaming import chunk_dataset
    p = inp["params"]
    mesh = _mesh(world)
    x, x_val, c0 = inp["x"], inp["x_val"], _t(inp["c0"])
    cfg = MiniBatchConfig(k=c0.shape[0], chunk_size=int(p["chunk"]),
                          epochs=2)
    out = {"mesh": [], "chunks": chunk_dataset(x, cfg.chunk_size, mesh=mesh)}
    for _ in range(2):
        out["mesh"].append(tuple(aa_kmeans_minibatch_streamed(
            x, x_val, c0, cfg, "fused", seed=5, drop_remainder=True,
            mesh=mesh)))
    out["local"] = tuple(aa_kmeans_minibatch_streamed(
        x, x_val, c0, cfg, "fused", seed=5, drop_remainder=True,
        device="cpu"))
    return out


def _launches():
    """Every kernel's launches and plain-version calls so far."""
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    return {"fused_lloyd": F.launches, "assignment": A.launches,
            "update": U.launches, "fused_bounds": F.bounds_launches,
            "plain": F.plain_calls + A.plain_calls + U.plain_calls
            + F.bounds_plain_calls}


@case
def gpu_solve(rank, world, inp, work):
    """On the card: AAKMeans(mesh=) against the undistributed fit in the
    same process, and their predicts."""
    from repro_torch.core import AAKMeans
    mesh = _mesh(world)
    x, k = inp["x"], int(inp["params"]["k"])
    before = _launches()
    m = AAKMeans(n_clusters=k, backend="fused", mesh=mesh, seed=0).fit(x)
    pred = m.predict(x)
    launches = {key: v - before[key] for key, v in _launches().items()}
    one = AAKMeans(n_clusters=k, backend="fused", seed=0).fit(x)
    fields = ("centroids_", "labels_", "energy_", "n_iter_", "n_accepted_")
    return {"mesh": [getattr(m, f) for f in fields],
            "local": [getattr(one, f) for f in fields],
            "predict": (pred, one.predict(x)), "launches": launches}


@case
def gpu_steps(rank, world, inp, work):
    """On the card: two steps of each kernel engine through
    ``distribute`` on this rank's rows (at c, then at c2), with the
    launches."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.backends import distribute, get_backend
    from repro_torch.core.backends.bounds import extract_stats
    mesh = _mesh(world)
    x = D.local_block(inp["x"], mesh, ("data",))
    c, c2 = (torch.from_numpy(inp[key]).to(x.device) for key in ("c", "c2"))
    k = c.shape[0]
    out = {}
    for name, opts in (("fused", {}), ("pallas", {}),
                       ("fused_bounds", {"group_size": 16})):
        bk = distribute(get_backend(name, **opts), ("data",))
        before = _launches()
        with D.mesh_scope(mesh):
            res, carry = bk.step(x, c, k, bk.init_carry(x, c, k))
            res2, carry = bk.step(x, c2, k, carry)
        st = extract_stats(carry)
        out[name] = {
            "steps": [tuple(t.cpu() for t in r) for r in (res, res2)],
            "stats": None if st is None else tuple(t.cpu() for t in st),
            "launches": {key: v - before[key]
                         for key, v in _launches().items()}}
    return out

if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
