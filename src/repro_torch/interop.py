"""Carry state of the reference package across into the port.

Both functions take numpy arrays (or objects whose leaves are numpy
arrays) — what the reference's ``AAKMeans.save`` artifact and
``jax.device_get`` give — so this module needs nothing of the reference.

    estimator_from_arrays(params, arrays)  -> fitted port AAKMeans
    batched_state_from_numpy(tree)         -> port _BatchedState
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.anderson import AAState
from repro_torch.core.api import AAKMeans
from repro_torch.core.backends.bounds import BoundStats
from repro_torch.core.kmeans import _BatchedState, _LoopState
from repro_torch.device import resolve_device

# Reference constructor fields the port has no counterpart for; they do
# not change what a fitted model predicts, so they are dropped.  Any
# other unknown field raises.
_DROPPED = ("mesh", "data_axes", "metrics", "serving_index", "hierarchical")


def _backend_name(enc):
    """The reference records a backend as its registry name, or as a dict
    with the name and a precision policy (repro/core/api.py:227)."""
    if isinstance(enc, str):
        return enc
    if set(enc) != {"name"}:
        raise NotImplementedError(
            f"backend {enc!r}: only the float32 precision is ported")
    return enc["name"].split("@")[0]


def estimator_from_arrays(params: Mapping, arrays: Mapping,
                          device=None) -> AAKMeans:
    """A fitted port ``AAKMeans`` from the reference's persisted state.

    ``params`` are the constructor parameters of the reference's
    ``AAKMeans.save`` (its ``meta["params"]``); ``arrays`` hold
    ``centroids_`` and optionally ``labels_``, ``energy_``, ``n_iter_``
    and ``n_accepted_`` as numpy arrays or scalars."""
    fields = {f.name for f in dataclasses.fields(AAKMeans)
              if not f.name.endswith("_")}
    unknown = set(params) - fields - set(_DROPPED)
    if unknown:
        raise ValueError(f"parameters with no counterpart in the port: "
                         f"{sorted(unknown)}")
    kwargs = {key: val for key, val in params.items() if key in fields}
    if "backend" in kwargs:
        kwargs["backend"] = _backend_name(kwargs["backend"])
    kwargs["device"] = device
    model = AAKMeans(**kwargs)
    dev = resolve_device(device)
    model.centroids_ = torch.as_tensor(
        np.asarray(arrays["centroids_"], np.float32), device=dev)
    if arrays.get("labels_") is not None:
        model.labels_ = torch.as_tensor(
            np.asarray(arrays["labels_"], np.int32), device=dev)
    for name, cast in (("energy_", float), ("n_iter_", int),
                       ("n_accepted_", int)):
        if arrays.get(name) is not None:
            setattr(model, name, cast(np.asarray(arrays[name])))
    return model


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _carry(node, device):
    """A backend carry: () for the stateless engines, or the bound
    contract (labels, upper, lower, c_last, BoundStats) — the reference's
    BoundStats is matched by its field names."""
    if getattr(node, "_fields", None) == BoundStats._fields:
        return BoundStats(*(_t(a, device) for a in node))
    if isinstance(node, tuple):
        return tuple(_carry(a, device) for a in node)
    return _t(node, device)


def batched_state_from_numpy(tree, device=None) -> _BatchedState:
    """The port's ``_BatchedState`` from the reference's (numpy leaves of
    ``repro.core.kmeans._BatchedState``: ``inner`` a ``_LoopState`` with
    an ``AAState`` window and a backend carry, plus ``pending``).  Field
    names match, so one iteration can run in both packages from identical
    state."""
    dev = resolve_device(device)
    inner = tree.inner
    aa = AAState(*(_t(getattr(inner.aa, f), dev) for f in AAState._fields))
    leaves = {f: _t(getattr(inner, f), dev) for f in _LoopState._fields
              if f not in ("aa", "carry")}
    return _BatchedState(
        _LoopState(aa=aa, carry=_carry(tuple(inner.carry), dev), **leaves),
        _t(tree.pending, dev))
