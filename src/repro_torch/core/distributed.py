"""Distributed AA-KMeans on ``torch.distributed`` (counterpart of
``repro.core.distributed``: ``distributed_lloyd_ops`` :48,
``_mesh_shards`` :77 as ``data.streaming.shard_count``,
``loop_state_specs`` :90,
``restore_distributed_loop_state`` :128, ``make_distributed_kmeans``
:159, ``_resolve_distributed`` :273, ``make_distributed_kmeans_batched``
:284, ``make_distributed_kmeans_minibatch`` :328, ``shard_dataset``
:380).

The layout is the reference's (DESIGN.md §Distribution): X is sharded by
rows over the mesh's data axes, the centroids are replicated, and the
solver's only communication is one reduction of the (K, d+1) stats and
the energy per step, plus the convergence test's integer count.  Every
rank solves the same small Anderson system on the same bits, so the
acceleration adds no communication.

The reference is single-controller: one process calls the solver on the
global X and ``shard_map`` runs the local code per shard.  The port is
SPMD: every rank makes the same call on the same global host array, and
the functions here keep the rows of this rank's shard (a ``Shard``; the
coordinates along ``data_axes`` flattened row-major in axis order, the
reference's ``P(axes)`` layout).  ``mesh`` is a ``DeviceMesh`` with named
dims; the caller initialises the process group (``torchrun``, spawned
processes), never the port.  A rank computes on the mesh's device
(``device.mesh_device``): the current CUDA device on a CUDA mesh, where
the kernels launch, or the CPU on a "cpu" mesh, where their plain
versions run.

``backends.distribute`` binds axis names, as ``psum`` does.  The drivers
run inside ``mesh_scope(mesh)``, where a wrapped collective finds the
process group of its axes (built once per axes, collectively, and
cached); outside a scope it raises, as an unbound axis name does.

Every reduction is deterministic and equal on every rank: each rank's
partials are gathered (``all_gather``) and added in shard order, whatever
algorithm the collective library picks, so replicated state never
differs by a bit between ranks and a one-rank mesh gives the local
solve's bits.  Gloo runs its collectives on host tensors here: a card
tensor is staged through pinned host memory for that backend, always
(Gloo takes card tensors as well, but its own copy was the slower one:
``scripts/gloo_cuda_probe.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import serialize
from repro_torch.core.backends import (Backend, distribute, get_backend,
                                       refuse_bf16)
from repro_torch.core.kmeans import (KMeansConfig, KMeansResult, _LoopState,
                                     _check_resume_meta, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     loop_state_like, resolve_backend,
                                     select_best)
from repro_torch.core.lloyd import LloydOps
from repro_torch.core.minibatch import MiniBatchConfig, MiniBatchResult
from repro_torch.core.segmented import Share, aa_kmeans_segmented
from repro_torch.data.streaming import Shard, shard_count, shard_index
from repro_torch.device import mesh_device

ROWS, REPLICATED = "rows", "replicated"

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


class _AxisGroup(NamedTuple):
    group: object          # the ProcessGroup of this rank's axes
    size: int              # W, ranks in it
    order: tuple           # group ranks in shard order
    members: tuple         # global ranks in group-rank order
    gloo: bool             # Gloo: collectives on host tensors
    device: torch.device   # the mesh's device


_GROUPS: dict = {}
# collectives run since reset_collective_counts, by what they reduce
_COUNTS: dict = {}
_TIMING = {"on": False, "seconds": 0.0}


@contextlib.contextmanager
def mesh_scope(mesh):
    """Bind the axis names of ``distribute``d backends to ``mesh`` for
    the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def collective_counts() -> dict:
    """The collectives run since ``reset_collective_counts``: "step" (a
    step's stats and energy), "converged" (the convergence test),
    "stats", "energy", "scalar", "gather", "broadcast"."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()
    _TIMING["seconds"] = 0.0


def time_collectives(on: bool) -> None:
    """Time every collective on the host clock, with a sync before and
    after (``collective_seconds``); the syncs cost time, so this is for
    measuring only."""
    _TIMING["on"] = bool(on)


def collective_seconds() -> float:
    return _TIMING["seconds"]


def _build_group(mesh, axes) -> _AxisGroup:
    names = tuple(mesh.mesh_dim_names or ())
    unknown = [a for a in axes if a not in names]
    if unknown:
        raise ValueError(f"mesh axes {unknown} are not dims of the mesh "
                         f"{names}")
    dims = [names.index(a) for a in axes]
    ranks = mesh.mesh
    if len(dims) == 1:
        group = mesh.get_group(axes[0])
    else:
        # one group per coordinate of the other dims, created in the same
        # order on every rank (new_group is collective)
        other = [i for i in range(ranks.dim()) if i not in dims]
        rows = ranks.permute(other + dims).reshape(
            -1, shard_count(mesh, axes)).tolist()
        me, group = dist.get_rank(), None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                group = g
    members = tuple(dist.get_process_group_ranks(group))
    sizes = [ranks.shape[i] for i in dims]

    def shard_of(rank):
        coord = (ranks == rank).nonzero()[0].tolist()
        s = 0
        for i, size in zip(dims, sizes):
            s = s * size + coord[i]
        return s

    order = tuple(sorted(range(len(members)),
                         key=lambda i: shard_of(members[i])))
    return _AxisGroup(group, len(members), order, members,
                      dist.get_backend(group) == "gloo", mesh_device(mesh))


def _axis_group(axes) -> _AxisGroup:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError(
            f"a collective over mesh axes {tuple(axes)} ran outside a mesh "
            f"scope; run distributed backends through the "
            f"make_distributed_* drivers or inside "
            f"distributed.mesh_scope(mesh)")
    key = (id(mesh), tuple(axes))
    hit = _GROUPS.get(key)
    if hit is None or hit[0] is not mesh:
        hit = _GROUPS[key] = (mesh, _build_group(mesh, tuple(axes)))
    return hit[1]


def axis_size(axes: Sequence[str]) -> int:
    """W, the ranks of the current mesh's ``axes``."""
    return _axis_group(axes).size


def _timed(fn):
    if not _TIMING["on"]:
        return fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    _TIMING["seconds"] += time.perf_counter() - t0
    return out


def _to_wire(ag: _AxisGroup, t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` where the group's backend takes it: pinned host
    memory for Gloo (which takes card tensors too, but copies them
    through the host itself), the mesh's card for NCCL."""
    if ag.gloo and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t.to(ag.device, copy=True) if not ag.gloo else t.clone()


def _gather(ag: _AxisGroup, t: torch.Tensor, what: str) -> torch.Tensor:
    """(W, *t.shape): every rank's ``t``, in shard order, on t's device."""
    _COUNTS[what] = _COUNTS.get(what, 0) + 1

    def run():
        src = _to_wire(ag, t.contiguous())
        bufs = [torch.empty_like(src) for _ in range(ag.size)]
        dist.all_gather(bufs, src, group=ag.group)
        return torch.stack([bufs[i] for i in ag.order]).to(t.device)
    return _timed(run)


def all_sum(tensors: Sequence[torch.Tensor], axes: Sequence[str],
            what: str = "step") -> list:
    """Each tensor summed over the ranks of ``axes``, in ONE collective:
    the tensors (of one dtype) are packed into one buffer, every rank's
    buffer is gathered, and the buffers are added in shard order, so
    every rank gets the same bits (and a one-rank mesh its own)."""
    ag = _axis_group(axes)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all_sum packs one dtype per call; got {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = _gather(ag, flat, what)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    out, at = [], 0
    for t in tensors:
        out.append(acc[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def gather_rows(t: torch.Tensor, axes: Sequence[str],
                dim: int = 0) -> torch.Tensor:
    """Every rank's block of a ``dim``-sharded tensor, concatenated in
    shard order: the global tensor, on every rank."""
    g = _gather(_axis_group(axes), t, "gather")
    g = torch.movedim(g, 0, dim)
    return g.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 1:])


def broadcast(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Shard 0's ``t`` on every rank of ``axes`` (``t`` gives the shape
    and dtype on the others)."""
    ag = _axis_group(axes)
    _COUNTS["broadcast"] = _COUNTS.get("broadcast", 0) + 1
    src = _to_wire(ag, t.contiguous())
    dist.broadcast(src, src=ag.members[ag.order[0]], group=ag.group)
    return src.to(t.device)


# -- placing global arrays ---------------------------------------------------

def _global_len(a, dim: int = 0) -> int:
    return a.n if isinstance(a, Shard) else int(a.shape[dim])


def local_block(a, mesh, axes: Sequence[str], dim: int = 0
                ) -> torch.Tensor:
    """This rank's block of ``a`` along ``dim`` on the mesh's device: a
    ``Shard``'s own block, or the block of a global host array or tensor,
    whose length along ``dim`` must divide by the shard count.  float64
    narrows to float32, as the estimators narrow X."""
    refuse_bf16("a mesh (core/distributed.py)", None,
                a.local if isinstance(a, Shard) else a)
    dev = mesh_device(mesh)
    if isinstance(a, Shard):
        if a.dim != dim:
            raise ValueError(f"a Shard of dim {a.dim} where dim {dim} is "
                             f"sharded")
        return a.local.to(dev)
    w = shard_count(mesh, axes)
    n = int(a.shape[dim])
    if n % w:
        raise ValueError(f"N={n} must be divisible by the {w} shards of "
                         f"{tuple(axes)} (pad via shard_dataset first)")
    s, b = shard_index(mesh, axes), n // w
    if isinstance(a, torch.Tensor):
        block = a.narrow(dim, s * b, b)
    else:
        block = torch.from_numpy(np.ascontiguousarray(
            np.take(np.asarray(a), np.arange(s * b, (s + 1) * b), axis=dim)))
    if block.dtype == torch.float64:
        block = block.to(torch.float32)
    return block.to(dev).contiguous()


def shard_dataset(x, mesh, data_axes: Sequence[str] = ("data",)):
    """Place a host array on the mesh, padding N to the shard count.
    -> (``Shard`` of this rank's rows on the mesh's device, pad).

    As in the reference, padding rows copy the final sample, which
    counts it again in the energy and its cluster's mean; the estimators
    give those rows weight 0 instead (ROADMAP queue C)."""
    refuse_bf16("a mesh (core/distributed.py)", None, x)
    axes = tuple(data_axes)
    w = shard_count(mesh, axes)
    n = int(x.shape[0])
    pad = (-n) % w
    b = (n + pad) // w
    s = shard_index(mesh, axes)
    idx = np.minimum(np.arange(s * b, (s + 1) * b), n - 1)
    if isinstance(x, torch.Tensor):
        rows = x[torch.from_numpy(idx).to(x.device)]
    else:
        rows = torch.from_numpy(np.ascontiguousarray(np.asarray(x)[idx]))
    if rows.dtype == torch.float64:
        rows = rows.to(torch.float32)
    return Shard(rows.to(mesh_device(mesh)).contiguous(), n + pad), pad


# -- the state's layout ------------------------------------------------------

def _map2(fn, tree, spec):
    """fn(leaf, spec_leaf) over two trees of one structure."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, a, b) for a, b in zip(tree, spec)))
    if isinstance(tree, tuple):
        return tuple(_map2(fn, a, b) for a, b in zip(tree, spec))
    return fn(tree, spec)


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, a) for a in tree))
    if isinstance(tree, tuple):
        return tuple(_map(fn, a) for a in tree)
    return fn(tree)


def loop_state_specs(local_backend: Backend, cfg: KMeansConfig, x_local,
                     c0, axes: Sequence[str]) -> _LoopState:
    """A ``_LoopState`` of ``ROWS`` / ``REPLICATED`` markers: which
    leaves a mesh shards by rows (labels, the previous assignment, and
    any per-row carry leaf) and which it replicates (the centroids,
    energies, the Anderson window, the counters).  A carry leaf is
    per-row when its leading dim follows the row count, found by
    building the state's layout (on the meta device) at a second N: a
    centroid-shaped leaf, such as hamerly's (K, d) c_last, is not
    mistaken for one when K equals the local row count."""
    n, d = int(x_local.shape[0]), int(x_local.shape[1])

    def like(rows):
        xm = torch.empty((rows, d), dtype=torch.float32, device="meta")
        return loop_state_like(xm, c0, cfg, local_backend)

    at_n, probe = like(n), like(n + 1)

    def carry_spec(leaf, probe_leaf):
        per_row = leaf.dim() >= 1 and leaf.shape[:1] != probe_leaf.shape[:1]
        return ROWS if per_row else REPLICATED

    return _LoopState(
        c=REPLICATED, c_au=REPLICATED, p_prev=ROWS, e_prev=REPLICATED,
        e_prev2=REPLICATED, aa=_map(lambda _: REPLICATED, at_n.aa),
        t=REPLICATED, n_acc=REPLICATED, converged=REPLICATED, labels=ROWS,
        e_last=REPLICATED, carry=_map2(carry_spec, at_n.carry, probe.carry))


def _gather_state(state, specs, axes):
    return _map2(lambda leaf, s: gather_rows(leaf, axes) if s == ROWS
                 else leaf, state, specs)


def _slice_state(state, specs, mesh, axes):
    return _map2(lambda leaf, s: local_block(leaf, mesh, axes)
                 if s == ROWS else leaf, state, specs)


def restore_distributed_loop_state(path, x, c0, cfg: KMeansConfig,
                                   local_backend: Backend, mesh,
                                   data_axes: Sequence[str] = ("data",)):
    """Elastic restore: a solver snapshot onto ``mesh``.  -> (this rank's
    state on the mesh's device, meta).

    Snapshots hold the global state (gathered to the writing rank), so
    the mesh's geometry appears nowhere in them and a snapshot restores
    onto another world size or mesh shape: every rank reads the file and
    keeps its block of the per-row leaves.  ``x`` (the global array, a
    ``Shard`` or anything with its shape) and ``c0`` give the problem's
    shapes; the snapshot's engine is checked up to the "@axes" suffix."""
    axes = tuple(data_axes)
    n = _global_len(x)
    w = shard_count(mesh, axes)
    if n % w:
        raise ValueError(
            f"N={n} must divide over the {w} shards of mesh axes {axes} "
            f"to restore onto this mesh (pad via shard_dataset first)")
    d = int(x.local.shape[1] if isinstance(x, Shard) else x.shape[1])
    xm = torch.empty((n, d), dtype=torch.float32, device="meta")
    meta, by_path = serialize.load(path, expect_kind=serialize.KIND_LOOP)
    _check_resume_meta(meta, cfg, local_backend, str(path))
    state = serialize.fill(by_path, loop_state_like(xm, c0, cfg,
                                                    local_backend),
                           device=mesh_device(mesh), path=path)
    specs = loop_state_specs(local_backend, cfg, xm[: n // w], c0, axes)
    return _slice_state(state, specs, mesh, axes), meta


# -- the drivers -------------------------------------------------------------

def distributed_lloyd_ops(data_axes: Sequence[str],
                          block_n: int = 0) -> LloydOps:
    """DEPRECATED: LloydOps whose update, energy and convergence test
    reduce over ``data_axes``.  Superseded by ``distribute(backend,
    axes)``; kept so legacy injection sites keep working.  Call inside a
    mesh scope with x as this rank's rows and c replicated."""
    from repro_torch.core import lloyd
    axes = tuple(data_axes)

    def assign_fn(x, c):
        return lloyd.assign(x, c, block_n=block_n)

    def update_fn(x, labels, k, c_prev):
        sums, counts = all_sum(list(lloyd.cluster_sums(x, labels, k)), axes,
                               "stats")
        return lloyd.update_from_sums(sums, counts, c_prev.to(sums.dtype)
                                      ).to(c_prev.dtype)

    def energy_fn(x, c, labels):
        return all_sum([lloyd.energy(x, c, labels)], axes, "energy")[0]

    def all_equal_fn(a, b):
        neq = torch.sum((a != b).to(torch.int64))
        return all_sum([neq], axes, "converged")[0] == 0

    return LloydOps(assign_fn=assign_fn, update_fn=update_fn,
                    energy_fn=energy_fn, all_equal_fn=all_equal_fn,
                    reduce_scalar=lambda s: all_sum([s], axes, "scalar")[0])


def _resolve_local(backend, block_n: int) -> Backend:
    if isinstance(backend, str) and backend in ("dense", "blocked") \
            and block_n:
        return get_backend("blocked", block_n=block_n)
    if backend is None and block_n:
        return get_backend("blocked", block_n=block_n)
    return resolve_backend(backend)


def _resolve_distributed(backend, cfg, block_n, axes) -> Backend:
    local = _resolve_local(backend, block_n)
    if local.axes:
        if local.axes != axes:
            raise ValueError(
                f"backend {local.name!r} is distributed over {local.axes} "
                f"but the solver reduces over {axes}")
        return local
    return distribute(local, axes)


def _writes(mesh) -> bool:
    """Only the mesh's first rank writes snapshots."""
    return dist.get_rank() == int(mesh.mesh.reshape(-1)[0])


def make_distributed_kmeans(mesh, cfg: KMeansConfig,
                            data_axes: Sequence[str] = ("data",),
                            block_n: int = 0,
                            backend: Union[str, Backend, None] = None,
                            checkpoint_every: int = 0,
                            checkpoint_dir=None, *, metrics=None,
                            keep_last_n: int = 0, keep_every_m: int = 0,
                            sync_writes: bool = False) -> Callable:
    """The multi-rank solver.  -> ``fit(x, c0, resume_from=None) ->
    KMeansResult`` with the result's labels global on every rank.

    Every rank calls ``fit`` with the global X (N, d) (a host array or
    tensor, or this rank's ``Shard``) and the same c0 (K, d); it solves
    on its block of rows, whose count N must divide by the shard count.
    ``backend`` is a registry name or a local Backend, wrapped here by
    ``distribute``; a backend already wrapped over ``data_axes`` is used
    as it is.

    Persistence: with ``checkpoint_every`` or ``checkpoint_dir`` set, or
    ``resume_from`` passed to fit, the solve runs ``aa_kmeans``'s
    segmented loop.  At each boundary the per-row leaves are gathered in
    shard order and only the mesh's first rank writes the snapshot
    (through the checkpoint writer, with ``"mesh"`` (dim name -> size)
    and ``"data_axes"`` in its meta), so snapshots are mesh-free:
    ``resume_from`` (a path, read on every rank, or this rank's state
    tree) restores onto another mesh or world size.  A run resumed at
    the same world size equals the uninterrupted one bit for bit; at
    another, the reduction order differs.  ``metrics`` gets the segmented
    loop's scalars (``gather_s`` among them) on the ranks given one."""
    axes = tuple(data_axes)
    ops = _resolve_distributed(backend, cfg, block_n, axes)
    local = None if isinstance(backend, Backend) and backend.axes \
        else _resolve_local(backend, block_n)
    dev = mesh_device(mesh)

    def _segmented(xl, n, c0, resume_from):
        if local is None:
            raise ValueError(
                "checkpointed distributed solves need a local backend "
                "(registry name or un-distributed instance) so the state "
                "layout can be derived; got a pre-distributed backend")
        specs = loop_state_specs(local, cfg, xl, c0, axes)
        if isinstance(resume_from, (str, os.PathLike)):
            resume_from, _ = restore_distributed_loop_state(
                resume_from, Shard(xl, n), c0, cfg, local, mesh, axes)
        share = Share(
            gather=lambda st: _gather_state(st, specs, axes),
            writes=_writes(mesh),
            extra={"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   "data_axes": list(axes)})
        return aa_kmeans_segmented(
            xl, c0, cfg, ops, checkpoint_every, checkpoint_dir, resume_from,
            None, keep_last_n, keep_every_m, metrics, sync_writes, share)

    def fit(x, c0, resume_from=None) -> KMeansResult:
        xl = local_block(x, mesh, axes)
        c0 = torch.as_tensor(c0).to(dev, torch.float32)
        with mesh_scope(mesh):
            if not checkpoint_every and checkpoint_dir is None \
                    and resume_from is None and metrics is None:
                res = aa_kmeans(xl, c0, cfg, backend=ops)
            else:
                res = _segmented(xl, _global_len(x), c0, resume_from)
            return res._replace(labels=gather_rows(res.labels, axes))

    return fit


def make_distributed_kmeans_batched(mesh, cfg: KMeansConfig,
                                    data_axes: Sequence[str] = ("data",),
                                    block_n: int = 0,
                                    backend: Union[str, Backend,
                                                   None] = None,
                                    pick_best: bool = False) -> Callable:
    """The batched multi-restart solver on a mesh.  -> ``fit(x, c0s,
    weights=None) -> KMeansResult`` with a leading R axis (labels (R, N),
    global on every rank), or the best restart with ``pick_best``.

    x as for ``make_distributed_kmeans``; c0s (R, K, d) the same on every
    rank; ``weights`` (R, N) (global, or a ``Shard`` of dim 1) scales the
    rows, so padding rows of weight 0 vanish.  Each trip is one batched
    step for all R restarts and ONE collective of the (R, K, d+1) stats,
    not R, plus the convergence test's."""
    axes = tuple(data_axes)
    ops = _resolve_distributed(backend, cfg, block_n, axes)

    def fit(x, c0s, weights=None) -> KMeansResult:
        xl = local_block(x, mesh, axes)
        c0s = torch.as_tensor(c0s).to(xl.device, torch.float32)
        wl = None if weights is None else local_block(weights, mesh, axes,
                                                      dim=1)
        with mesh_scope(mesh):
            res = aa_kmeans_batched(xl, c0s, cfg, backend=ops, weights=wl)
            res = res._replace(labels=gather_rows(res.labels, axes, dim=1))
        return select_best(res) if pick_best else res

    return fit


def make_distributed_kmeans_minibatch(mesh, cfg: MiniBatchConfig,
                                      data_axes: Sequence[str] = ("data",),
                                      backend: Union[str, Backend,
                                                     None] = None
                                      ) -> Callable:
    """The streaming mini-batch solver on a mesh.  -> ``fit(chunks,
    weights, x_val, c0, generator=None) -> MiniBatchResult``.

    ``chunks`` (n_chunks, B, d) and ``weights`` (n_chunks, B) have their
    row dim sharded over ``data_axes`` (``data.streaming.chunk_dataset(
    mesh=...)`` makes such ``Shard``s; global arrays are sliced here), and
    ``x_val`` (V, d) likewise by rows; c0 is the same on every rank.  The
    chunk order comes from ``generator``, a CPU generator seeded alike on
    every rank (default seed 0), so every rank takes the same order.  A
    chunk step costs one (K, d+1) collective, and the guard's one of its
    two candidates' stats and energies.  B and V must divide by the
    shard count."""
    axes = tuple(data_axes)
    ops = _resolve_distributed(backend, None, 0, axes)
    dev = mesh_device(mesh)

    def fit(chunks, weights, x_val, c0, generator=None) -> MiniBatchResult:
        cl = local_block(chunks, mesh, axes, dim=1)
        wl = local_block(weights, mesh, axes, dim=1)
        vl = local_block(x_val, mesh, axes)
        c0 = torch.as_tensor(c0).to(dev, torch.float32)
        with mesh_scope(mesh):
            return aa_kmeans_minibatch(cl, wl, vl, c0, cfg, backend=ops,
                                       generator=generator, device=dev)

    return fit


def rows_apply(mesh, axes: Sequence[str], x, fn: Callable) -> np.ndarray:
    """``fn(rows) -> (rows, ...) host array`` on this rank's block of X
    (padded to the shard count with copies of the last row), gathered
    over the ranks in shard order with the padding stripped: the global
    result, on every rank (the estimators' predict and transform)."""
    axes = tuple(axes)
    n = int(x.shape[0])
    x_sh, _ = shard_dataset(x, mesh, axes)
    out = torch.from_numpy(np.ascontiguousarray(fn(x_sh.local)))
    with mesh_scope(mesh):
        return gather_rows(out, axes)[:n].numpy()


def on_shard_zero(mesh, axes: Sequence[str], make: Callable,
                  likes: Sequence[torch.Tensor]) -> tuple:
    """``make()`` (a tuple of tensors) on the rank holding shard 0 of
    each ``axes`` group, broadcast to the others, which receive tensors
    of the shapes and dtypes of ``likes``: how the estimators seed once
    on the global X, as the reference does before its ``shard_map``."""
    with mesh_scope(mesh):
        ag = _axis_group(axes)
        if ag.members[ag.order[0]] == dist.get_rank():
            likes = tuple(t.to(like.device, like.dtype)
                          for t, like in zip(make(), likes))
        return tuple(broadcast(t, axes) for t in likes)
