"""The step-primitive backend protocol of Algorithm 1 (counterpart of
``repro.core.backends.base``, lines 57-290; ``distribute`` and the
derived ``energy`` op are still to be ported).

A backend's core op is one logical pass over X,

    step(x, c, k, carry) -> (StepResult(labels, min_sqdist, sums, counts,
                                        energy), carry)

from which the next centroids follow without touching X again
(``centroids_from_step``).  ``batched_step`` runs R centroid sets at once
(leading R axis on every output, x shared (N, d) or per-problem
(R, N, d), optional (R, N) row weights); ``minibatch_step`` weights rows
of one problem.  ``carry`` is per-backend state threaded through the
solver loop: ``()`` for the stateless engines, the bound contract of
``backends/bounds.py`` for ``fused_bounds``.  ``stats_fn`` gives the
partial stats of a known assignment, from which the derived ``update``
op follows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import lloyd
from repro_torch.core.lloyd import AssignResult


class StepResult(NamedTuple):
    """Everything one pass over X yields for one Algorithm-1 iteration.

    labels     : (N,) int32 — fresh assignment
    min_sqdist : (N,) f32 — squared distance to the assigned centroid
    sums       : (K, d) f32 weighted per-cluster sums
    counts     : (K,) f32 per-cluster weight totals
    energy     : () f32 — sum(w * min_sqdist)
    (each with a leading R axis from ``batched_step``)"""
    labels: torch.Tensor
    min_sqdist: torch.Tensor
    sums: torch.Tensor
    counts: torch.Tensor
    energy: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Precision:
    """Compute-vs-accumulate dtype policy.  This slice runs f32 only: a
    compute or accumulate dtype other than float32 raises (bf16 is still
    to be ported)."""
    compute: Optional[Any] = None
    accum: Optional[Any] = None

    def __post_init__(self):
        for dt in (self.compute, self.accum):
            if dt is not None and dt != torch.float32:
                raise NotImplementedError(
                    f"Precision({dt}) — only float32 is ported so far")


DEFAULT_PRECISION = Precision()


def _default_init_carry(x, c, k):
    return ()


def _default_finalize(x, res: StepResult, k: int, c_prev):
    """G(C) from the step's partial stats — no further pass over X."""
    c_new = lloyd.update_from_sums(res.sums, res.counts,
                                   c_prev.to(res.sums.dtype))
    return c_new.to(c_prev.dtype)


def _rows_all_equal(a, b):
    """True where two (.., N) label arrays agree on every row."""
    return torch.all(a == b, dim=-1)


@dataclasses.dataclass(frozen=True)
class Backend:
    """A local-compute engine for Algorithm 1, keyed by the step primitive.
    Use `get_backend` rather than constructing directly."""
    name: str
    # (x, c, k, carry) -> (StepResult, carry): ONE pass over X.
    step_fn: Callable = None
    # (x, cs, k, carries, w=None) -> (StepResult with a leading R axis,
    # carries); cs (R, K, d), x (N, d) shared or (R, N, d), w (R, N).
    batched_step_fn: Callable = None
    # (x, c, k, w, carry) -> (StepResult, carry); w (N,) row weights.
    minibatch_step_fn: Callable = None
    # (x, labels, k) -> (sums, counts): partial stats of a known
    # assignment (the update half of G; the derived update op).
    stats_fn: Callable = None
    # (x, c) -> AssignResult: standalone assignment (predict).
    assign_fn: Callable = None
    # (a, b) -> bool per leading row: assignments identical.
    all_equal_fn: Callable = _rows_all_equal
    init_carry_fn: Callable = _default_init_carry
    # (x, res, k, c_prev) -> next centroids.
    finalize_fn: Callable = _default_finalize
    precision: Precision = DEFAULT_PRECISION

    def step(self, x, c, k, carry=()):
        return self.step_fn(x, c, k, carry)

    def batched_step(self, x, cs, k, carries, w=None):
        return self.batched_step_fn(x, cs, k, carries, w=w)

    def minibatch_step(self, x, c, k, w, carry=()):
        return self.minibatch_step_fn(x, c, k, w, carry)

    def init_carry(self, x, c, k):
        return self.init_carry_fn(x, c, k)

    def centroids_from_step(self, x, res: StepResult, k: int, c_prev):
        return self.finalize_fn(x, res, k, c_prev)

    def assign(self, x, c) -> AssignResult:
        return self.assign_fn(x, c)

    def update(self, x, labels, k, c_prev):
        """Next centroids of a known assignment: stats, then Eq. 4."""
        sums, counts = self.stats_fn(x, labels, k)
        c_new = lloyd.update_from_sums(sums, counts,
                                       c_prev.to(sums.dtype))
        return c_new.to(c_prev.dtype)

    def all_equal(self, a, b):
        return self.all_equal_fn(a, b)


_REGISTRY: dict = {}
_INSTANCES: dict = {}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Register a backend factory under a string key (replacing any
    previous factory and its cached instances)."""
    _REGISTRY[name] = factory
    for key in [key for key in _INSTANCES if key[0] == name]:
        del _INSTANCES[key]


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **opts) -> Backend:
    """Construct (and cache) a backend by name: "dense" | "fused" |
    "pallas" | "fused_bounds"."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{', '.join(backend_names())}")
    key = (name, tuple(sorted(opts.items())))
    if key not in _INSTANCES:
        _INSTANCES[key] = _REGISTRY[name](**opts)
    return _INSTANCES[key]
