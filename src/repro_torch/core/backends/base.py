"""The step-primitive backend protocol of Algorithm 1 (counterpart of
``repro.core.backends.base``, lines 57-290 and 395-475; ``distribute`` is
still to be ported).

A backend's core op is one logical pass over X,

    step(x, c, k, carry) -> (StepResult(labels, min_sqdist, sums, counts,
                                        energy), carry)

from which the next centroids follow without touching X again
(``centroids_from_step``).  ``batched_step`` runs R centroid sets at once
(leading R axis on every output, x shared (N, d) or per-problem
(R, N, d), optional (R, N) row weights); ``minibatch_step`` weights rows
of one problem.  An engine that sets only ``step_fn`` gets both: the
batched slot runs ``step`` per restart and stacks the results and carries
(the reference's ``jax.vmap``), with weights the minibatch slot per
problem; the minibatch slot runs ``step`` and reweights its stats with
one segment sum.  ``carry`` is per-backend state threaded through the
solver loop: ``()`` for the stateless engines, the bound contract of
``backends/bounds.py`` for ``fused_bounds``.  ``stats_fn`` gives the
partial stats of a known assignment, from which the derived ``update``
op follows; ``energy``, ``g_map`` and ``reduce_scalar`` are the other
derived ops.  ``from_lloyd_ops`` adapts a legacy ``lloyd.LloydOps`` and
``instrument`` counts the passes over X.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import lloyd
from repro_torch.core.lloyd import AssignResult, LloydOps


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


def _tree_index(tree, i: int):
    """Row i of every leaf of a carry (tensors, tuples, NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_index(a, i) for a in tree))
    if isinstance(tree, tuple):
        return tuple(_tree_index(a, i) for a in tree)
    raise TypeError(f"cannot index a carry leaf of {type(tree).__name__}")


def _tree_stack(trees):
    """Stack R structurally equal carries leaf by leaf (leading R axis);
    the inverse of ``_tree_index``, keeping NamedTuple types."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_stack(list(ls)) for ls in zip(*trees)))
    if isinstance(first, tuple):
        return tuple(_tree_stack(list(ls)) for ls in zip(*trees))
    raise TypeError(f"cannot stack carry leaves of {type(first).__name__}")


@dataclasses.dataclass(frozen=True)
class Backend:
    """A local-compute engine for Algorithm 1, keyed by the step primitive.
    Use `get_backend` rather than constructing directly."""
    name: str
    # (x, c, k, carry) -> (StepResult, carry): ONE pass over X.
    step_fn: Callable = None
    # Optional: (x, cs, k, carries, w=None) -> (StepResult with a leading
    # R axis, carries); cs (R, K, d), x (N, d) shared or (R, N, d), w
    # (R, N).  When None, ``batched_step`` runs ``step_fn`` per restart.
    batched_step_fn: Optional[Callable] = None
    # Optional: (x, c, k, w, carry) -> (StepResult, carry); w (N,) row
    # weights.  When None, ``minibatch_step`` reweights a plain step.
    minibatch_step_fn: Optional[Callable] = None
    # (x, labels, k) -> (sums, counts): partial stats of a known
    # assignment (the update half of G; the derived update op).
    stats_fn: Callable = None
    # (x, c) -> AssignResult: standalone assignment (predict).
    assign_fn: Callable = None
    # (x, c, labels) -> scalar energy of a fixed assignment.
    energy_fn: Callable = lloyd.energy
    # (a, b) -> bool per leading row: assignments identical.
    all_equal_fn: Callable = _rows_all_equal
    reduce_scalar: Callable = lloyd._identity
    init_carry_fn: Callable = _default_init_carry
    # (x, res, k, c_prev) -> next centroids.
    finalize_fn: Callable = _default_finalize
    precision: Precision = DEFAULT_PRECISION

    def step(self, x, c, k, carry=()):
        return self.step_fn(x, c, k, carry)

    def batched_step(self, x, cs, k, carries, w=None):
        """R restarts' steps at once.  Without a ``batched_step_fn`` it
        runs ``step`` per restart (with ``w``, the minibatch slot per
        problem) and stacks every leaf of the results and carries."""
        if self.batched_step_fn is not None:
            return self.batched_step_fn(x, cs, k, carries, w=w)
        outs = []
        for i in range(cs.shape[0]):
            xi = x[i] if x.dim() == 3 else x
            carry = _tree_index(carries, i)
            if w is None:
                outs.append(self.step_fn(xi, cs[i], k, carry))
            else:
                outs.append(self.minibatch_step(xi, cs[i], k, w[i], carry))
        return (_tree_stack([o[0] for o in outs]),
                _tree_stack([o[1] for o in outs]))

    def minibatch_step(self, x, c, k, w, carry=()):
        """Weighted single pass: ``w`` (N,) scales each row's share of the
        stats and the energy.  Without a ``minibatch_step_fn`` it runs
        ``step`` and one weighted segment sum over the rows."""
        if self.minibatch_step_fn is not None:
            return self.minibatch_step_fn(x, c, k, w, carry)
        res, carry = self.step_fn(x, c, k, carry)
        wa = w.to(res.sums.dtype)
        sums, counts = lloyd.weighted_cluster_sums(
            x.to(res.sums.dtype), res.labels, wa, k)
        energy = torch.sum(res.min_sqdist.to(res.energy.dtype) * wa)
        return StepResult(res.labels, res.min_sqdist, sums, counts,
                          energy), carry

    def init_carry(self, x, c, k):
        return self.init_carry_fn(x, c, k)

    def batched_init_carry(self, x, cs, k):
        """The carries of R restarts: the engine's own batched carry when
        it batches natively, else ``init_carry`` per restart, stacked."""
        if self.batched_step_fn is not None:
            return self.init_carry_fn(x, cs, k)
        return _tree_stack([
            self.init_carry_fn(x[i] if x.dim() == 3 else x, cs[i], k)
            for i in range(cs.shape[0])])

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

    def energy(self, x, c, labels):
        return self.energy_fn(x, c, labels)

    def all_equal(self, a, b):
        return self.all_equal_fn(a, b)

    def g_map(self, x, c, k):
        """One fixed-point map application; -> (G(c), StepResult)."""
        res, _ = self.step(x, c, k, self.init_carry(x, c, k))
        return self.centroids_from_step(x, res, k, c), res


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
    """Construct (and cache) a backend by name: "dense" | "blocked" |
    "fused" | "pallas" | "fused_bounds"."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{', '.join(backend_names())}")
    key = (name, tuple(sorted(opts.items())))
    if key not in _INSTANCES:
        _INSTANCES[key] = _REGISTRY[name](**opts)
    return _INSTANCES[key]


_OPS_ADAPTERS: "weakref.WeakKeyDictionary[LloydOps, Backend]" = \
    weakref.WeakKeyDictionary()


def _per_row(fn, x, *rows):
    """fn(x_i, *row_i) for each leading row, stacked (x shared or per
    problem)."""
    return torch.stack([fn(x[i] if x.dim() == 3 else x, *(r[i] for r in rows))
                        for i in range(rows[0].shape[0])])


def from_lloyd_ops(ops: LloydOps) -> Backend:
    """Adapt a legacy LloydOps container to the Backend protocol.

    The step is ``ops.assign_fn`` plus the cluster stats of its labels,
    and ``centroids_from_step`` routes through ``ops.update_fn``, so the
    old container's semantics and two-pass cost are kept.  Adapters are
    memoised per LloydOps (weakly), as in the reference.  The batched
    driver hands finalize and the convergence test (R, ...) operands;
    both run the container's unbatched functions row by row."""
    cached = _OPS_ADAPTERS.get(ops)
    if cached is not None:
        return cached

    def step_fn(x, c, k, carry):
        res = ops.assign_fn(x, c)
        sums, counts = lloyd.cluster_sums(x.to(torch.float32), res.labels, k)
        e = ops.reduce_scalar(lloyd.energy_from_mindist(res.min_sqdist))
        return StepResult(res.labels, res.min_sqdist, sums, counts, e), carry

    def finalize_fn(x, res, k, c_prev):
        if c_prev.dim() == 3:
            return _per_row(lambda xi, lab, cp: ops.update_fn(xi, lab, k, cp),
                            x, res.labels, c_prev)
        return ops.update_fn(x, res.labels, k, c_prev)

    def stats_fn(x, labels, k):
        return lloyd.cluster_sums(x.to(torch.float32), labels, k)

    def all_equal_fn(a, b):
        if a.dim() == 2:
            return torch.stack([ops.all_equal_fn(ai, bi)
                                for ai, bi in zip(a, b)])
        return ops.all_equal_fn(a, b)

    backend = Backend(name="lloyd-ops-shim", step_fn=step_fn,
                      stats_fn=stats_fn, assign_fn=ops.assign_fn,
                      energy_fn=ops.energy_fn, all_equal_fn=all_equal_fn,
                      reduce_scalar=ops.reduce_scalar,
                      finalize_fn=finalize_fn)
    _OPS_ADAPTERS[ops] = backend
    return backend


def instrument(backend: Backend, on_step: Callable[[], None]) -> Backend:
    """Wrap a backend so ``on_step`` fires once per executed pass over X.
    Each slot the backend sets is counted where it runs; a slot it leaves
    unset stays unset, so its fallback routes through the counted
    ``step_fn`` and is counted there, once."""

    def counted(fn):
        if fn is None:
            return None

        def wrapped(*args, **kwargs):
            on_step()
            return fn(*args, **kwargs)
        return wrapped

    return dataclasses.replace(
        backend, name=f"{backend.name}+count",
        step_fn=counted(backend.step_fn),
        batched_step_fn=counted(backend.batched_step_fn),
        minibatch_step_fn=counted(backend.minibatch_step_fn))
