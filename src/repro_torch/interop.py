"""Carry state of the reference package across into the port.

The functions take numpy arrays (or objects whose leaves are numpy
arrays) — what the reference's ``AAKMeans.save`` artifact and
``jax.device_get`` give — so this module needs nothing of the reference.

    estimator_kwargs(cls, params)          -> port constructor keywords
    estimator_from_arrays(params, arrays)  -> fitted port AAKMeans
    batched_state_from_numpy(tree)         -> port _BatchedState
    minibatch_state_from_numpy(tree)       -> port MiniBatchState
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.anderson import AAState
from repro_torch.core.api import AAKMeans, _decode_backend, host_tensor
from repro_torch.core.backends.bounds import BoundStats
from repro_torch.core.kmeans import _BatchedState, _LoopState
from repro_torch.core.minibatch import MiniBatchState, from_reference_layout
from repro_torch.device import resolve_device

# Reference constructor fields a persisted artifact may name that a
# loaded model does not take: the mesh is a property of the process (the
# reference never persists it either), so a loaded model is local.  Any
# other unknown field raises.
_DROPPED = ("mesh",)


def estimator_kwargs(cls, params: Mapping, device=None,
                     where="params") -> dict:
    """Constructor keywords of the port's estimator ``cls`` from the
    reference's (or the port's) persisted ``params``: fields in
    ``_DROPPED`` are dropped, any other unknown field raises ValueError,
    the backend is rebuilt by ``api._decode_backend`` and ``data_axes``
    (a list in the meta) becomes a tuple.  ``device`` is
    the process's, never persisted."""
    fields = {f.name for f in dataclasses.fields(cls)
              if not f.name.endswith("_") and not f.name.startswith("_")}
    unknown = set(params) - fields - set(_DROPPED)
    if unknown:
        raise ValueError(f"{where}: parameters with no counterpart in the "
                         f"port: {sorted(unknown)}")
    kwargs = {key: val for key, val in params.items()
              if key in fields and key not in _DROPPED}
    if "backend" in kwargs:
        kwargs["backend"] = _decode_backend(kwargs["backend"], where)
    if "data_axes" in kwargs:
        kwargs["data_axes"] = tuple(kwargs["data_axes"])
    kwargs["device"] = device
    return kwargs


def estimator_from_arrays(params: Mapping, arrays: Mapping,
                          device=None) -> AAKMeans:
    """A fitted port ``AAKMeans`` from the reference's persisted state.

    ``params`` are the constructor parameters of the reference's
    ``AAKMeans.save`` (its ``meta["params"]``); ``arrays`` hold
    ``centroids_`` and optionally ``labels_``, the serving index's
    ``closure_routers_`` and ``closure_candidates_``, a hierarchical
    fit's ``hier_routers_`` and ``hier_offsets_``, ``energy_``,
    ``n_iter_`` and ``n_accepted_`` as numpy arrays or scalars."""
    model = AAKMeans(**estimator_kwargs(AAKMeans, params, device))
    dev = resolve_device(device)
    cent = np.asarray(arrays["centroids_"])
    # a bf16 model's centroids stay bf16; anything else is float32
    model.centroids_ = host_tensor(
        cent if cent.dtype.name == "bfloat16" else cent.astype(np.float32)
    ).to(dev)
    for name, dt in (("labels_", np.int32),
                     ("closure_routers_", np.float32),
                     ("closure_candidates_", np.int32),
                     ("hier_routers_", np.float32),
                     ("hier_offsets_", np.int32)):
        if arrays.get(name) is not None:
            setattr(model, name, torch.as_tensor(
                np.asarray(arrays[name], dt), device=dev))
    for name, cast in (("energy_", float), ("n_iter_", int),
                       ("n_accepted_", int)):
        if arrays.get(name) is not None:
            setattr(model, name, cast(np.asarray(arrays[name])))
    return model


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _carry(node, device):
    """A backend carry, leaf by leaf: () for the stateless engines; the
    bound contract (labels, upper, lower, c_last, BoundStats), lower
    (N, G) or hamerly's (N,); or the locality engine's (perm, inv,
    labels_sort, t, n_sorts, inner carry), whose t and n_sorts are (R,)
    in a batched state.  The reference's BoundStats is matched by its
    field names."""
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


def minibatch_state_from_numpy(tree, device=None) -> MiniBatchState:
    """The port's ``MiniBatchState`` from the reference's (numpy leaves of
    ``repro.core.minibatch.MiniBatchState``), so one chunk step can run in
    both packages from identical mid-stream state.  The reference's one
    Anderson window gains the port's leading window axis of 1, and its
    step count ``t`` becomes the host int the port keeps."""
    dev = resolve_device(device)
    aa = AAState(*(_t(getattr(tree.aa, f), dev) for f in AAState._fields))
    leaves = {f: _t(getattr(tree, f), dev) for f in MiniBatchState._fields
              if f != "aa"}
    return from_reference_layout(MiniBatchState(aa=aa, **leaves))
