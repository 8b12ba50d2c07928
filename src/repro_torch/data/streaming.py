"""Chunk pipeline of the streaming mini-batch solver (counterpart of
``repro.data.streaming``).

Two regimes, one chunk contract:

  * **Device-resident** (``chunk_dataset``): X fits on the device; it is
    reshaped once into fixed-size chunks with a row-weight mask for the
    padded tail, and the epoch driver takes the chunks in a per-epoch
    shuffled order (a view per chunk, no copy of X per epoch).
  * **Host-streamed** (``host_chunk_stream``): X lives in host memory
    only; a generator yields one shuffled numpy chunk at a time, so the
    device holds O(chunk + validation chunk).

Every chunk of ``chunk_dataset`` has exactly ``chunk_size`` rows; rows
past the true N copy the last row and carry weight 0, so they vanish
from every weighted reduction.

``stream_chunks`` puts both behind one iterator of device chunks,
routing host chunks through ``runtime.prefetch.prefetch_to_device`` so
that copies overlap compute.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``), chunk rows are
sharded over its ``data_axes``: each rank holds the rows of its shard
index (``shard_index``: its coordinates along the axes, flattened
row-major in axis order), the reference's ``P(None, axes)`` layout, as a
``Shard`` on the mesh's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import mesh_device
from repro_torch.runtime.prefetch import prefetch_to_device


class Shard(NamedTuple):
    """This rank's block of a global array sharded along ``dim`` over a
    mesh's data axes: the counterpart of a jax array with a
    ``NamedSharding``.  Every rank holds one; block s covers
    [s * n / W, (s + 1) * n / W) of the global dim."""
    local: torch.Tensor   # on the mesh's device
    n: int                # the global length of ``dim``, padding included
    dim: int = 0


def shard_count(mesh, data_axes: Sequence[str]) -> int:
    """Total shards of the given mesh data axes: the divisor every
    row-sharded dimension must respect."""
    count = 1
    for a in data_axes:
        count *= mesh.size(mesh.mesh_dim_names.index(a))
    return count


def shard_index(mesh, data_axes: Sequence[str]) -> int:
    """This rank's shard along the data axes: its mesh coordinates on
    those axes, flattened row-major in the order of ``data_axes``."""
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    idx = 0
    for a in data_axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _shard_block(n: int, mesh, data_axes, what: str) -> slice:
    """The slice of a length-n dim this rank holds; n must divide."""
    shards = shard_count(mesh, data_axes)
    if n % shards:
        raise ValueError(f"{what}={n} must be divisible by the {shards} "
                         f"shards of mesh axes {tuple(data_axes)}")
    b = n // shards
    s = shard_index(mesh, data_axes)
    return slice(s * b, (s + 1) * b)


class DeviceChunks(NamedTuple):
    """Device-resident chunked dataset.

    chunks  : (n_chunks, chunk_size, d) — padded rows copy the last real
              row (any finite value works; the mask removes them).
    weights : (n_chunks, chunk_size) — 1.0 for real rows, 0.0 for padding.
    n       : the true (unpadded) row count.
    With a mesh (``chunk_dataset(mesh=)``), ``chunks`` and ``weights``
    are ``Shard``s of dim 1: this rank's rows of every chunk.
    """
    chunks: torch.Tensor
    weights: torch.Tensor
    n: int


def chunk_dataset(x: torch.Tensor, chunk_size: int, mesh=None,
                  data_axes: Sequence[str] = ("data",)) -> DeviceChunks:
    """X (N, d) as masked fixed-size chunks on X's device.  The tail chunk
    is padded to ``chunk_size`` with copies of the last row at weight 0.

    With ``mesh``, chunk rows are sharded over ``data_axes``: ``chunks``
    and ``weights`` are ``Shard``s of dim 1 holding this rank's
    ``chunk_size / W`` rows of every chunk on the mesh's device, gathered
    from X (a host array or a tensor) without copying the other ranks'
    rows; ``chunk_size`` must divide by the shard count W."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1; got {chunk_size}")
    if mesh is not None:
        return _sharded_chunks(x, chunk_size, mesh, tuple(data_axes))
    x = torch.as_tensor(x)
    n, d = x.shape
    pad = (-n) % chunk_size
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, d)])
    w = torch.cat([torch.ones((n,), dtype=torch.float32, device=x.device),
                   torch.zeros((pad,), dtype=torch.float32,
                               device=x.device)])
    return DeviceChunks(x.reshape(-1, chunk_size, d),
                        w.reshape(-1, chunk_size), n)


def _sharded_chunks(x, chunk_size: int, mesh, axes) -> DeviceChunks:
    block = _shard_block(chunk_size, mesh, axes, "chunk_size")
    n = x.shape[0]
    n_chunks = -(-n // chunk_size)
    rows = torch.arange(n_chunks * chunk_size).reshape(
        n_chunks, chunk_size)[:, block]
    live = rows < n
    src = torch.clamp_max(rows, n - 1).reshape(-1)
    dev = mesh_device(mesh)
    if isinstance(x, torch.Tensor):
        local = x[src.to(x.device)]
    else:
        local = torch.from_numpy(np.ascontiguousarray(
            np.asarray(x)[src.numpy()]))
    local = local.to(dev).reshape(n_chunks, -1, x.shape[1])
    w = live.to(dtype=torch.float32, device=dev)
    return DeviceChunks(Shard(local, chunk_size, 1), Shard(w, chunk_size, 1),
                        n)


def split_validation(x: torch.Tensor, val_size: int,
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hold out ``val_size`` uniformly drawn rows as the guard's
    validation chunk; ``generator`` lives on x's device.  Returns
    (x_train, x_val); the split permutes rows, so the train rows come
    already shuffled."""
    n = x.shape[0]
    if not 0 < val_size < n:
        raise ValueError(f"val_size must be in (0, N={n}); got {val_size}")
    perm = torch.randperm(n, generator=generator, device=x.device)
    return x[perm[val_size:]], x[perm[:val_size]]


def host_chunk_stream(x, chunk_size: int, epochs: int = 1, seed: int = 0,
                      drop_remainder: bool = False, start_chunk: int = 0):
    """Generator over host-memory (numpy) chunks, reshuffled per epoch —
    the reference's numpy code, so its chunks are the reference's bit for
    bit.

    Each yield gathers one (chunk_size, d) array, so X never needs to fit
    on the device.  The tail chunk of each epoch is shorter than
    ``chunk_size`` unless ``drop_remainder``.  The stream is a function of
    (x, chunk_size, epochs, seed): ``start_chunk`` skips the first chunks
    without touching X's rows, so a restarted stream resumes on the chunk
    the stopped one would have seen next."""
    x = np.asarray(x)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    skip = int(start_chunk)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, chunk_size):
            idx = order[i:i + chunk_size]
            if drop_remainder and idx.shape[0] < chunk_size:
                break
            if skip > 0:
                skip -= 1
                continue
            yield x[idx]


def _sorted_chunk_iter(host_iter, sort_by):
    """Stably sort each host chunk's rows by nearest centroid before the
    copy to the device.

    ``sort_by`` is a (K, d) host array of centroids, or a zero-argument
    callable returning one: the streamed driver passes a callable that
    reads its current iterate, so chunks made ``prefetch`` steps ahead
    sort by slightly stale centroids.  That shapes locality only, never
    the numbers (the chunk stats are row-weighted sums).  The sort runs
    on the host, in numpy, as in the reference."""
    provider = sort_by if callable(sort_by) else (lambda: sort_by)
    for chunk in host_iter:
        rows = np.asarray(chunk)
        c = np.asarray(provider())
        d2 = (np.square(rows).sum(-1)[:, None]
              - 2.0 * rows @ c.T + np.square(c).sum(-1)[None, :])
        labels = np.argmin(d2, axis=1)
        yield rows[np.argsort(labels, kind="stable")]


def _sharded_rows(host_iter, mesh, axes):
    """Each host chunk's rows of this rank's shard (a view: the copy to
    the device takes only these rows)."""
    for chunk in host_iter:
        rows = np.asarray(chunk)
        yield rows[_shard_block(rows.shape[0], mesh, axes, "chunk rows")]


def stream_chunks(source, chunk_size: Optional[int] = None, *,
                  epochs: int = 1, seed: int = 0, start_chunk: int = 0,
                  drop_remainder: bool = False, prefetch: int = 2,
                  device=None, meter=None, sort_by=None, mesh=None,
                  data_axes: Sequence[str] = ("data",)):
    """One iterator of device chunks over both regimes:

      * a ``DeviceChunks`` — its chunks in storage order, no copies;
        ``chunk_size`` / ``epochs`` / ``seed`` / ``start_chunk`` /
        ``drop_remainder`` / ``sort_by`` must stay at their defaults
        (shuffling device-resident chunks is the epoch driver's job);
      * a host array — ``host_chunk_stream`` (per-epoch shuffle,
        ``start_chunk`` skipping) through ``prefetch_to_device``;
      * any iterator of host chunks — prefetched as it comes
        (``chunk_size`` is ignored).

    Host chunks go to ``device`` (None: CUDA) with up to ``prefetch``
    copies in flight (2 = double buffering; 1 = copy, then yield);
    ``meter`` is an optional ``IngestMeter``.

    ``sort_by`` (a (K, d) centroid array, or a zero-argument callable
    returning one) stably sorts each host chunk's rows by nearest centroid
    before the copy.  A callable that reads centroids on the card (the
    streamed driver's) costs one device-to-host copy, and so one sync,
    per chunk, as in the reference.

    With ``mesh``, each host chunk's rows are sharded over ``data_axes``
    (every chunk's length must divide by the shard count): this rank
    copies only its block of rows, to the mesh's device (``device`` may
    only repeat it).  A sharded ``DeviceChunks`` yields its local
    blocks."""
    if isinstance(source, DeviceChunks):
        if chunk_size is not None or epochs != 1 or start_chunk \
                or seed != 0 or drop_remainder or sort_by is not None:
            raise ValueError(
                "stream_chunks(DeviceChunks) yields storage order; "
                "chunk_size/epochs/seed/start_chunk/drop_remainder/"
                "sort_by do not apply")
        chunks = source.chunks
        return iter(chunks.local if isinstance(chunks, Shard) else chunks)
    if hasattr(source, "__next__") or not hasattr(source, "shape"):
        host_iter = iter(source)
    else:
        if chunk_size is None:
            raise ValueError("chunk_size is required for a host array")
        host_iter = host_chunk_stream(source, chunk_size, epochs=epochs,
                                      seed=seed, start_chunk=start_chunk,
                                      drop_remainder=drop_remainder)
    if sort_by is not None:
        host_iter = _sorted_chunk_iter(host_iter, sort_by)
    if mesh is not None:
        host_iter = _sharded_rows(host_iter, mesh, tuple(data_axes))
        device = mesh_device(mesh, device)
    return prefetch_to_device(host_iter, size=max(1, int(prefetch)),
                              device=device, meter=meter)
