"""Versioned solver-state artifacts (counterpart of
``repro.core.serialize``; the two packages read each other's files).

Artifact format — a single ``.npz`` file, no pickle anywhere:

  * each leaf is stored as an ``npy`` member ``a<i>``, in the leaf order
    of ``flatten_with_paths``; a bfloat16 leaf is stored as a 2-byte void
    (its bits), as the reference stores an ml_dtypes leaf, and its true
    dtype is in the metadata;
  * member ``__meta__`` is a MessagePack blob (``core/_msgpack.py``, the
    port's own codec): ``schema`` (format version), ``kind`` (which state
    tree this is), per-leaf ``path`` / ``shape`` / ``dtype`` (numpy's
    dtype names), plus caller metadata.

Trees are dicts, tuples, lists and NamedTuples whose leaves are tensors
or numpy arrays; ``None`` is an empty subtree.  Paths and leaf order are
jax's ``tree_flatten_with_path``'s: dict keys sorted, NamedTuple fields
in field order, sequence items by index, joined with "/".

``restore`` fills a caller's "like" tree — built, for instance, on
``torch.device("meta")`` from the port's own init functions, so that
the structure comes from the code — with shape checks per leaf, and
returns tensors on the resolved device in the like leaves' dtypes.

Schema evolution: ``load`` refuses an artifact of a NEWER schema, and
upgrades an OLDER one through the per-kind migrations registered with
``register_migration``, failing loudly where a step has none.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import _msgpack
from repro_torch.device import resolve_device

SCHEMA_VERSION = 1

# Registered state kinds (informational: `load` checks the caller's
# expectation, not membership).
KIND_LOOP = "loop_state"             # kmeans._LoopState
KIND_BATCHED = "batched_state"       # kmeans._BatchedState
KIND_MINIBATCH = "minibatch_stream"  # {"state": MiniBatchState, "key", ...}
KIND_HIERARCHY = "hierarchy_state"   # hierarchy round state
KIND_ESTIMATOR_AA = "estimator/aa_kmeans"
KIND_ESTIMATOR_MB = "estimator/minibatch_aa_kmeans"

PyTree = Any

# numpy dtype names that torch holds natively; "bfloat16" is read from its
# bits.  Any other dtype (ml_dtypes' float8 and int4 families, ...) is
# refused: it would need a package the port does not depend on.
_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {dt: name for name, dt in _TORCH_DTYPES.items()}

# {(kind, from_schema): migrate}: ``migrate(meta, by_path)`` returns the
# pair upgraded to ``from_schema + 1``.  A gap in the chain means the
# artifact cannot be interpreted, and `load` fails loudly.
_MIGRATIONS: dict = {}


def register_migration(kind: str, from_schema: int, fn) -> None:
    """Register ``fn(meta, by_path) -> (meta, by_path)`` upgrading
    ``kind`` artifacts from ``from_schema`` to ``from_schema + 1``."""
    _MIGRATIONS[(kind, int(from_schema))] = fn


def unregister_migration(kind: str, from_schema: int) -> None:
    _MIGRATIONS.pop((kind, int(from_schema)), None)


def _migrate(path, meta: dict, by_path: dict):
    """Chain registered migrations until ``meta['schema']`` reaches
    SCHEMA_VERSION; loud failure when a step has no migration."""
    while meta["schema"] < SCHEMA_VERSION:
        step = (meta.get("kind"), meta["schema"])
        fn = _MIGRATIONS.get(step)
        if fn is None:
            raise ValueError(
                f"{path}: artifact schema {meta['schema']} predates this "
                f"code's {SCHEMA_VERSION} and no migration is registered "
                f"for kind {meta.get('kind')!r} at schema "
                f"{meta['schema']} — refusing to guess at the old layout")
        meta, by_path = fn(dict(meta), dict(by_path))
        if meta["schema"] <= step[1]:
            meta["schema"] = step[1] + 1    # migrations may omit the bump
    return meta, by_path


def _items(node):
    """(key, child) pairs of an inner node in jax's order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), child) for i, child in enumerate(node)]
    return None


def flatten_with_paths(tree: PyTree):
    """Flatten a tree to (slash-joined path strings, leaves, treedef);
    ``treedef`` is the tree itself, which ``unflatten`` refills."""
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return
        items = _items(node)
        if items is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for key, child in items:
            walk(child, prefix + [key])

    walk(tree, [])
    return paths, leaves, tree


def unflatten(treedef: PyTree, leaves):
    """The tree ``treedef`` with its leaves replaced, in
    ``flatten_with_paths`` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(child) for child in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(treedef)


def _to_storable(leaf):
    """(numpy array that npy round-trips without pickle, numpy dtype
    name).  A tensor is copied to the host; bfloat16 is stored as its
    bits in a 2-byte void, as the reference stores an ml_dtypes leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"refusing to serialise a {t.dtype} leaf")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        return t.numpy(), _DTYPE_NAMES[t.dtype]
    a = np.asarray(leaf)
    if a.dtype.name not in _TORCH_DTYPES or a.dtype.name == "bfloat16":
        raise TypeError(f"refusing to serialise a {a.dtype} leaf (shape "
                        f"{a.shape}); trees hold tensors or numeric arrays")
    return a, a.dtype.name


def _from_storable(path, a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored member as a host tensor of its true dtype."""
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"{path}: leaf dtype {dtype!r} is not supported "
                         f"(only {sorted(_TORCH_DTYPES)})")
    want = _TORCH_DTYPES[dtype]
    if want == torch.bfloat16:
        # stored as the reference stores it: its bits in a 2-byte void
        if a.dtype != np.dtype("V2"):
            raise ValueError(f"{path}: a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype:
        raise ValueError(f"{path}: leaf stored as {a.dtype}, its meta says "
                         f"{dtype}")
    return torch.from_numpy(a)


def save(path: str | os.PathLike, tree: PyTree, *, kind: str,
         extra: Optional[dict] = None) -> Path:
    """Atomically write ``tree`` to ``path`` as a version-tagged npz
    (``.npz`` appended if missing; a tmp file, then ``os.replace``).
    Leaves are copied to the host.  ``extra`` is caller metadata of
    Python numbers, strings, lists and str-keyed dicts, merged into the
    meta block.  Returns the final path."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    paths, leaves, _ = flatten_with_paths(tree)
    stored, meta_leaves = [], []
    for p, leaf in zip(paths, leaves):
        a, dt = _to_storable(leaf)
        stored.append(a)
        meta_leaves.append({"path": p, "shape": list(a.shape), "dtype": dt})
    meta = {"schema": SCHEMA_VERSION, "kind": kind,
            "leaves": meta_leaves, **(extra or {})}
    blob = np.frombuffer(_msgpack.packb(meta), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=blob,
                 **{f"a{i}": a for i, a in enumerate(stored)})
    os.replace(tmp, path)   # a crash mid-write never corrupts an artifact
    return path


def load(path: str | os.PathLike, *, expect_kind: Optional[str] = None):
    """Read an artifact -> (meta dict, {leaf path: host tensor}).

    Refuses a NEWER schema than this code knows, upgrades an OLDER one
    through registered migrations (failing loudly on a gap) and, when
    ``expect_kind`` is given, checks that the artifact holds that kind."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        meta = _msgpack.unpackb(z["__meta__"].tobytes())
        arrays = [z[f"a{i}"] for i in range(len(meta["leaves"]))]
    schema = meta.get("schema")
    if not isinstance(schema, int) or schema > SCHEMA_VERSION:
        raise ValueError(
            f"{path}: artifact schema {schema!r} is newer than this "
            f"code's {SCHEMA_VERSION}; upgrade before restoring")
    if expect_kind is not None and meta.get("kind") != expect_kind:
        raise ValueError(
            f"{path}: artifact holds {meta.get('kind')!r} state, "
            f"expected {expect_kind!r}")
    by_path = {m["path"]: _from_storable(path, a, m["dtype"])
               for m, a in zip(meta["leaves"], arrays)}
    if schema < SCHEMA_VERSION:
        meta, by_path = _migrate(path, meta, by_path)
    return meta, by_path


def fill(by_path: dict, like: PyTree, *, prefix: str = "", device=None,
         path="") -> PyTree:
    """``like`` with each leaf replaced by ``by_path[prefix + its path]``:
    shape-checked, cast to the like leaf's dtype and put on the resolved
    device."""
    dev = resolve_device(device)
    want_paths, want_leaves, treedef = flatten_with_paths(like)
    missing = [p for p in want_paths if prefix + p not in by_path]
    if missing:
        raise ValueError(
            f"{path}: artifact is missing leaves {missing[:5]} "
            f"({len(missing)} of {len(want_paths)}) — was it saved from a "
            f"different backend or solver configuration?")
    out = []
    for p, w in zip(want_paths, want_leaves):
        a = by_path[prefix + p]
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(
                f"{path}: shape mismatch at {p}: artifact "
                f"{tuple(a.shape)} vs expected {tuple(w.shape)} — restore "
                f"must target the same (N, K, d) problem the snapshot "
                f"came from")
        dtype = w.dtype if isinstance(w.dtype, torch.dtype) else \
            _TORCH_DTYPES[np.dtype(w.dtype).name]
        out.append(a.to(device=dev, dtype=dtype))
    return unflatten(treedef, out)


def restore(path: str | os.PathLike, like: PyTree, *,
            expect_kind: Optional[str] = None, device=None):
    """Restore an artifact into the structure of ``like`` (tensors on any
    device, "meta" included, or numpy arrays: only their shapes and
    dtypes are read).  -> (tree of tensors on the resolved device, meta);
    ``device=None`` means CUDA."""
    meta, by_path = load(path, expect_kind=expect_kind)
    return fill(by_path, like, device=device, path=path), meta
