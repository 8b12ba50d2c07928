"""Estimator API (counterpart of ``repro.core.api``, lines 54-118,
310-512 and 550-873).

    from repro_torch.core import AAKMeans, MiniBatchAAKMeans
    model = AAKMeans(n_clusters=10, backend="fused").fit(x)   # on CUDA
    labels = model.predict(x_new)
    stream = MiniBatchAAKMeans(n_clusters=10, backend="fused").fit(x)

``backend`` names the engine: "fused" (one kernel pass per step),
"pallas" (the assignment kernel, then the update kernel), "fused_bounds"
(the fused pass skipping centroid groups by carried bounds), "dense"
(plain PyTorch, the oracle), the bound engines "hamerly", "elkan" and
"yinyang" (masked dense PyTorch), or any bound engine's "<name>_reorder"
variant (the locality engine: rows sorted by label once assignments
settle, e.g. ``get_backend("fused_bounds_reorder", group_size=64)``).

``fit`` seeds R = n_init restarts, solves them together with the batched
driver and keeps the best; ``predict`` / ``transform`` run in fixed-shape
chunks into host (numpy) arrays.  ``MiniBatchAAKMeans`` is the streaming
estimator: ``fit`` over device-resident chunks, ``partial_fit`` /
``partial_fit_stream`` over host chunks.  ``save`` / ``load`` write and
read the reference's artifact format (``core/serialize.py``), a
mid-stream ``partial_fit`` state included, so the two packages load each
other's models.  ``metrics`` (a ``runtime.metrics`` sink) gets the
solve's scalars at each segment boundary of ``fit``, and those of each
``partial_fit`` chunk.

``build_serving_index`` attaches a cluster-closure candidate index
(``repro_torch.serving.closure``) to a fitted model; ``AAKMeans(
serving_index=)`` builds one at each fit.  ``predict`` / ``transform``
with ``approx=True`` then scan only each row's candidate centroids (the
exact scan when the model has no index); ``save`` / ``load`` carry the
index.

``AAKMeans(hierarchical=True)`` (or a dict of keyword overrides) fits
through ``core.hierarchy.aa_kmeans_hierarchical``, the two-level solve
for large K, and keeps its routing (``hier_routers_``,
``hier_offsets_``): ``build_serving_index()`` with no sizes then turns
it into the serving index with no more clustering.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) with ``data_axes``
distributes both estimators' ``fit`` and ``predict`` / ``transform``
(``core/distributed.py``): every rank calls them with the same global X
and each solves on its shard of the rows.  Seeds are drawn on shard 0 of
the global X, as the single-device fit draws them, and broadcast; rows
padding N to the shard count get weight 0; labels come back global on
every rank.  ``partial_fit`` and ``hierarchical=`` refuse a mesh, and
``save`` persists ``data_axes`` but never the mesh.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import serialize
from repro_torch.core.anderson import AAConfig
from repro_torch.core.backends import (Precision, backend_names, get_backend,
                                       refuse_bf16)
from repro_torch.core.backends.base import PRECISION_DTYPES
from repro_torch.core.init_schemes import batched_init, make_init
from repro_torch.core.kmeans import (KMeansConfig, KMeansResult,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     resolve_backend, select_best)
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.core.minibatch import (MiniBatchConfig,
                                        from_reference_layout, guard_pick,
                                        minibatch_init, minibatch_iteration,
                                        reference_layout)
from repro_torch.data.streaming import (DeviceChunks, chunk_dataset,
                                        shard_count, split_validation,
                                        stream_chunks)
from repro_torch.device import mesh_device, resolve_device
from repro_torch.kernels.tiles import pad_rows
from repro_torch.runtime.metrics import as_metrics
from repro_torch.runtime.prefetch import IngestMeter

PREDICT_CHUNK = 16384


class NotFittedError(RuntimeError):
    """Inference was requested on an estimator with no fitted state."""


def host_tensor(x) -> torch.Tensor:
    """``x`` as a tensor.  A numpy array whose dtype is named bfloat16
    (what ``np.asarray`` of a jax bf16 array gives: an ml_dtypes type,
    which the port does not import) is read by its bits, as
    ``core/serialize.py`` reads a bf16 leaf."""
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(x).view(np.int16)).view(
                torch.bfloat16)
        if not x.flags.writeable:
            x = np.array(x)   # torch refuses to share read-only memory
    return torch.as_tensor(x)


def _as_input(x, device: torch.device) -> torch.Tensor:
    """X as a float32 or bfloat16 tensor on ``device``.  float64 input
    narrows to float32, as ``jnp.asarray`` does in the reference; a bf16
    X runs the whole solve in bf16 (seeds, the Anderson window and the
    centroids), its stats and energies in f32.  Other dtypes (float16)
    raise TypeError."""
    x = host_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    if x.dtype not in PRECISION_DTYPES:
        raise TypeError(f"X must be float32 or bfloat16; got {x.dtype} "
                        f"(ROADMAP.md queue B, \"bf16 paths refused\")")
    return x.to(device).contiguous()


def _chunked_rows_apply(model, x, fn, out_dtype, out_cols=None,
                        chunk_size=None) -> np.ndarray:
    """Run ``fn(x_chunk, centroids) -> per-row output`` chunk by chunk
    into a host (numpy) array.  Every chunk has EXACTLY ``chunk_size``
    rows — the tail is padded with copies of its last row and the padding
    sliced off — so the kernel behind ``fn`` always sees one shape."""
    step = chunk_size or PREDICT_CHUNK
    c = model.centroids_
    n = x.shape[0]
    out = np.empty((n,) if out_cols is None else (n, out_cols), out_dtype)
    for i in range(0, n, step):
        xc = _as_input(x[i:i + step], c.device)
        m = xc.shape[0]
        # a bf16 model's transform of bf16 rows is bf16, which numpy
        # lacks: it widens exactly
        res = fn(pad_rows(xc, step), c)[:m].cpu()
        out[i:i + m] = (res.float() if res.dtype == torch.bfloat16
                        else res).numpy()
    return out


def _rows_apply(model, x, fn, out_dtype, out_cols=None,
                chunk_size=None) -> np.ndarray:
    """``_chunked_rows_apply`` on one device, or under a fitted model's
    mesh on each rank's block of rows, gathered over the ranks with the
    padding stripped (the reference's ``_mesh_rows_apply``)."""
    if model.mesh is None:
        return _chunked_rows_apply(model, x, fn, out_dtype, out_cols,
                                   chunk_size)
    from repro_torch.core.distributed import rows_apply
    return rows_apply(model.mesh, model.data_axes, _host_array(x),
                      lambda xl: _chunked_rows_apply(
                          model, xl, fn, out_dtype, out_cols, chunk_size))


def _host_array(x):
    """X as it came (a tensor or an array), or an array of a list."""
    return x if hasattr(x, "shape") else np.asarray(x)


def _closure_extras(model):
    """(routers, candidates, candidate table) when the model carries a
    serving index, else None.  The (G, C, d) table is built once per
    inference call, so every chunk reads contiguous block rows."""
    if model.closure_routers_ is None:
        return None
    from repro_torch.serving.closure import candidate_table
    return (model.closure_routers_, model.closure_candidates_,
            candidate_table(model.centroids_, model.closure_candidates_))


def _predict_rows(model, x, chunk_size, approx=False) -> np.ndarray:
    """Either estimator's predict: labels through its backend's assign;
    ``approx=True`` through the closure index when the model carries one
    (the exact argmin over each row's candidate list), else the exact
    path.  A bf16 policy or bf16 X predicts through the backend's
    assignment in the operands' own dtypes (the policy does not apply:
    ``repro/core/api.py:154-155``); ``approx=True`` refuses both."""
    model._assert_fitted()
    if approx:
        refuse_bf16("approx=True (the serving index)", model.backend,
                    model.centroids_, x)
    extras = _closure_extras(model) if approx else None
    if extras is not None:
        from repro_torch.serving.closure import closure_assign
        return _rows_apply(
            model, x, lambda xc, c: closure_assign(xc, c, *extras)[0],
            np.int32, chunk_size=chunk_size)
    bk = resolve_backend(model.backend)
    return _rows_apply(
        model, x, lambda xc, c: bk.assign(xc, c).labels, np.int32,
        chunk_size=chunk_size)


def _transform_rows(model, x, chunk_size, approx=False) -> np.ndarray:
    """Either estimator's transform: distances to every centroid;
    ``approx=True`` with an index prices only each row's candidates and
    gives +inf elsewhere."""
    model._assert_fitted()
    if approx:
        refuse_bf16("approx=True (the serving index)", model.backend,
                    model.centroids_, x)
    extras = _closure_extras(model) if approx else None
    if extras is not None:
        from repro_torch.serving.closure import closure_sqdist
        return _rows_apply(
            model, x,
            lambda xc, c: torch.sqrt(closure_sqdist(xc, c, *extras)),
            np.float32, out_cols=model.n_clusters, chunk_size=chunk_size)
    return _rows_apply(
        model, x, lambda xc, c: torch.sqrt(pairwise_sqdist(xc, c)),
        np.float32, out_cols=model.n_clusters, chunk_size=chunk_size)


def _build_serving_index(model, n_candidates=None, n_groups=None, seed=0):
    """Build the cluster-closure index of a fitted model's centroids and
    attach it (``closure_routers_``, ``closure_candidates_``); ``save``
    persists it and ``load`` restores it.  A hierarchical fit's model
    asked for no sizes gets its own routing as the index
    (``serving.closure.hierarchy_closure_index``): the routers are its
    super-centroids and each group's codebook rows its candidates, so
    nothing is clustered."""
    model._assert_fitted()
    refuse_bf16("the serving index", model.backend, model.centroids_)
    if n_candidates is None and n_groups is None \
            and getattr(model, "hier_routers_", None) is not None:
        from repro_torch.serving.closure import hierarchy_closure_index
        idx = hierarchy_closure_index(model.centroids_, model.hier_routers_,
                                      model.hier_offsets_)
    else:
        from repro_torch.serving.closure import build_closure_index
        idx = build_closure_index(model.centroids_,
                                  n_candidates=n_candidates,
                                  n_groups=n_groups, seed=seed)
    model.closure_routers_ = idx.routers
    model.closure_candidates_ = idx.candidates
    return model


def _closure_index(model):
    """The model's ``ClosureIndex``, or None when none was built."""
    if model.closure_routers_ is None:
        return None
    from repro_torch.serving.closure import ClosureIndex
    return ClosureIndex(model.closure_routers_, model.closure_candidates_)


def _index_arrays(model) -> dict:
    """The serving index's arrays and a hierarchical fit's routing for
    ``save`` (none of either when the model has none)."""
    out = {}
    for a, b in (("closure_routers_", "closure_candidates_"),
                 ("hier_routers_", "hier_offsets_")):
        if getattr(model, a, None) is not None:
            out.update({a: getattr(model, a), b: getattr(model, b)})
    return out


# -- estimator persistence ---------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _encode_backend(bk):
    """A registry name passes through; a Backend instance is recorded as
    its name plus its precision policy, as the reference records one
    (``repro/core/api.py::_encode_backend``)."""
    if isinstance(bk, str):
        return bk
    enc = {"name": bk.name}
    if bk.precision.compute is not None:
        enc["compute"] = _dtype_name(bk.precision.compute)
    if bk.precision.accum is not None:
        enc["accum"] = _dtype_name(bk.precision.accum)
    return enc


# a persisted precision's dtype names (the reference's numpy names)
_PRECISION_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _decode_backend(enc, path):
    """The backend a persisted ``enc`` names: a registry name as it is, a
    recorded instance rebuilt from the registry (``blocked<N>`` as
    ``blocked`` with ``block_n=N``, a float32 or bfloat16 precision
    policy with it).  Another precision (float16) raises
    NotImplementedError; a name the registry cannot rebuild (an
    instrumented or wrapped instance's, "fused+count", "elkan+reorder")
    raises ValueError."""
    if isinstance(enc, str):
        name, opts = enc, None
    else:
        name, opts = enc["name"].split("@")[0], {}
        m = re.fullmatch(r"blocked(\d+)", name)
        if m:
            name, opts["block_n"] = "blocked", int(m.group(1))
        dts = {key: enc[key] for key in ("compute", "accum") if key in enc}
        if any(dt not in _PRECISION_NAMES for dt in dts.values()):
            raise NotImplementedError(
                f"{path}: model was fitted with the precision policy {dts} "
                f"of backend {enc['name']!r}; only float32 and bfloat16 "
                f"are ported (ROADMAP.md queue B, \"bf16 paths refused\")")
        if dts:
            opts["precision"] = Precision(
                **{key: _PRECISION_NAMES[dt] for key, dt in dts.items()})
    if name not in backend_names():
        raise ValueError(
            f"{path}: model was fitted with backend {enc!r}, which "
            f"cannot be rebuilt from the registry "
            f"({sorted(backend_names())}); construct the engine yourself "
            f"and set model.backend on the loaded model before serving")
    return name if opts is None else get_backend(name, **opts)


def _save_estimator(model, path, kind, arrays: dict, stream: dict,
                    scalars: dict):
    """One ``core/serialize.py`` artifact in the reference's layout:
    fitted arrays (and a streaming state) as the tree, the constructor
    params and the fitted scalars (Python numbers) in the meta block.
    ``device``, ``mesh`` and ``metrics`` are properties of the process,
    as in the reference, and are not persisted; ``data_axes`` is, as a
    list."""
    params = {}
    for f in dataclasses.fields(model):
        if f.name.endswith("_") or f.name.startswith("_") \
                or f.name in ("device", "mesh", "metrics"):
            continue
        v = getattr(model, f.name)
        if f.name == "backend":
            v = _encode_backend(v)
        elif f.name == "data_axes":
            v = list(v)
        params[f.name] = v
    tree = {"arrays": arrays}
    if stream:
        tree["stream"] = stream
    return serialize.save(
        path, tree, kind=kind,
        extra={"params": params, "scalars": scalars,
               "has": sorted(arrays), "has_stream": sorted(stream)})


def _load_estimator(cls, path, kind, device):
    """-> (model with its params, centroids_, the index's and the
    hierarchy's arrays and scalars set, meta, {leaf path: host tensor},
    device).  Refuses an artifact holding an array this estimator has no
    field for: loading it would drop it in silence."""
    # interop imports this module; it holds the params' mapping
    from repro_torch.interop import estimator_kwargs
    meta, by_path = serialize.load(path, expect_kind=kind)
    fitted = {f.name for f in dataclasses.fields(cls)
              if f.name.endswith("_")}
    unknown = sorted(set(meta["has"]) - fitted)
    if unknown:
        raise ValueError(
            f"{path}: the artifact holds {unknown}, which {cls.__name__} "
            f"has no field for in the port; loading it would drop them")
    dev = resolve_device(device)
    model = cls(**estimator_kwargs(cls, meta["params"], device, path))
    model.centroids_ = by_path["arrays/centroids_"].to(dev)
    for name in ("closure_routers_", "closure_candidates_",
                 "hier_routers_", "hier_offsets_"):
        if name in meta["has"]:
            setattr(model, name, by_path[f"arrays/{name}"].to(dev))
    for name, val in meta["scalars"].items():
        setattr(model, name, val)
    return model, meta, by_path, dev


def _host_number(v, cast):
    """A fitted scalar as a Python number (one read of a device scalar)."""
    return None if v is None else cast(v)


@dataclasses.dataclass
class AAKMeans:
    n_clusters: int
    init: str = "kmeans++"
    n_init: int = 1
    max_iter: int = 500
    accelerated: bool = True
    m0: int = 2
    mbar: int = 30
    dynamic_m: bool = True
    eps1: float = 0.02
    eps2: float = 0.5
    ridge: float = 1e-12
    seed: int = 0
    # a registry name ("dense" | "blocked" | "fused" | "pallas" |
    # "hamerly" | "elkan" | "yinyang" | "fused_bounds" | "<bound
    # engine>_reorder") or a Backend instance (e.g.
    # get_backend("fused_bounds_reorder", group_size=64))
    backend: object = "dense"
    # None means CUDA (RuntimeError without a card); "cpu" runs the
    # kernels' plain versions
    device: object = None
    # a runtime.metrics sink (None | "stdout" | anything with
    # log_scalars): the batched driver's segment boundaries emit the
    # solve's scalars to it.  Not persisted.
    metrics: object = None
    # the cluster-closure serving index: None builds none at fit time,
    # True builds one with the default sizes, an int one with that many
    # candidates; build_serving_index() attaches one to a fitted model
    # either way
    serving_index: object = None
    # the two-level fit for large K (core/hierarchy.py): False fits flat;
    # True calls aa_kmeans_hierarchical with its defaults (G = the divisor
    # of K nearest √K); a dict gives it keyword overrides (n_groups=,
    # n_reassign=, super_max_iter=, ...)
    hierarchical: object = False
    # a torch.distributed DeviceMesh: fit and predict run SPMD, X sharded
    # by rows over the mesh dims named by data_axes (core/distributed.py).
    # A process property: not persisted, and a loaded model is local.
    mesh: object = None
    data_axes: tuple = ("data",)

    # fitted state
    centroids_: Optional[torch.Tensor] = None
    labels_: Optional[torch.Tensor] = None
    energy_: Optional[float] = None
    n_iter_: Optional[int] = None
    n_accepted_: Optional[int] = None
    closure_routers_: Optional[torch.Tensor] = None
    closure_candidates_: Optional[torch.Tensor] = None
    # a hierarchical fit's routing: the (G, d) super-centroids and the
    # (G+1,) group offsets of the group-major codebook (the free serving
    # index; see build_serving_index)
    hier_routers_: Optional[torch.Tensor] = None
    hier_offsets_: Optional[torch.Tensor] = None

    def _config(self) -> KMeansConfig:
        return KMeansConfig(
            k=self.n_clusters, max_iter=self.max_iter,
            accelerated=self.accelerated,
            aa=AAConfig(m0=self.m0, mbar=self.mbar,
                        dynamic_m=self.dynamic_m,
                        eps1=self.eps1, eps2=self.eps2, ridge=self.ridge))

    def fit(self, x, c0s=None) -> "AAKMeans":
        """Fit on X (N, d).  ``c0s`` (R, K, d), when given, replaces the
        seeding (R = its first axis) — how a caller hands over seeds made
        elsewhere, e.g. by the reference package.  With ``hierarchical``
        set, ``c0s`` are the sub-problems' seeds of
        ``aa_kmeans_hierarchical`` ((G·n_init, K/G, d); (n_init, K, d) at
        G = 1).  With a ``mesh``, every rank calls ``fit`` with the same
        global X (``_fit_mesh``)."""
        if self.mesh is not None:
            return self._fit_mesh(x, c0s)
        dev = resolve_device(self.device)
        x = _as_input(x, dev)
        cfg = self._config()
        if self.hierarchical:
            return self._fit_hierarchical(
                x, cfg, None if c0s is None else _as_input(c0s, dev))
        if c0s is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            c0s = batched_init(self.init, gen, x, self.n_clusters,
                               max(self.n_init, 1))
        else:
            # given seeds stand in for the seeding, which draws rows of X
            c0s = _as_input(c0s, dev).to(x.dtype)
        return self._take(select_best(
            aa_kmeans_batched(x, c0s, cfg, backend=self.backend,
                              metrics=self.metrics)), c0s.shape[0],
            x.shape[0])

    def _take(self, best: KMeansResult, r: int, n: int) -> "AAKMeans":
        """Keep a flat fit's winner (its labels' first n rows)."""
        energy = float(best.energy)
        if not math.isfinite(energy):
            # select_best skips non-finite restarts, so EVERY restart
            # degenerated (NaN rows in X, exploded iterate).
            raise FloatingPointError(
                f"all {r} restarts produced non-finite energies "
                f"(E={energy}); check X for NaN/inf rows")
        self.centroids_ = best.centroids
        self.labels_ = best.labels[:n]
        self.energy_ = energy
        self.n_iter_ = int(best.n_iter)
        self.n_accepted_ = int(best.n_accepted)
        # new centroids make any earlier index and routing stale: rebuild
        # the index when asked to, never serve the old one
        self.hier_routers_ = self.hier_offsets_ = None
        return self._refresh_index()

    def _fit_mesh(self, x, c0s) -> "AAKMeans":
        """The fit on a mesh (the reference's ``make_distributed_kmeans_
        batched(pick_best=True)`` path): the seeds drawn on shard 0 over
        the global X from the single-device fit's generator, so a mesh
        fit from ``seed`` starts where the single-device fit does, and
        broadcast; X padded to the shard count with rows of weight 0,
        where the reference repeats its last row at weight 1."""
        if self.hierarchical:
            raise NotImplementedError(
                "hierarchical=True is a host-driven round loop; a "
                "mesh-distributed hierarchy is a ROADMAP follow-up — fit "
                "flat under the mesh or hierarchical on one device")
        refuse_bf16("a mesh (mesh=)", self.backend, x)
        from repro_torch.core import distributed as D
        dev = mesh_device(self.mesh, self.device)
        axes = tuple(self.data_axes)
        x = _host_array(x)
        n, d = int(x.shape[0]), int(x.shape[1])
        x_sh, pad = D.shard_dataset(x, self.mesh, axes)
        x_sh = x_sh._replace(local=_as_input(x_sh.local, dev))
        r = max(self.n_init, 1)
        if c0s is None:
            def seeds():
                gen = torch.Generator(device=dev).manual_seed(self.seed)
                return (batched_init(self.init, gen, _as_input(x, dev),
                                     self.n_clusters, r),)
            c0s, = D.on_shard_zero(self.mesh, axes, seeds, (torch.empty(
                (r, self.n_clusters, d), dtype=torch.float32, device=dev),))
        else:
            c0s = _as_input(c0s, dev)
        weights = None
        if pad:
            weights = torch.ones((c0s.shape[0], n + pad))
            weights[:, n:] = 0.0
        return self._take(D.make_distributed_kmeans_batched(
            self.mesh, self._config(), axes, backend=self.backend,
            pick_best=True)(x_sh, c0s, weights), c0s.shape[0], n)

    def _fit_hierarchical(self, x, cfg: KMeansConfig, c0s) -> "AAKMeans":
        """The two-level fit (``core.hierarchy``): the flat fit's contract
        (centroids_, labels_ in original row order, the finite-energy
        check) plus the routing, which ``save`` persists and the serving
        index reuses.  ``n_iter_`` is the rounds run; ``n_accepted_`` is
        None, as in the reference."""
        from repro_torch.core.hierarchy import aa_kmeans_hierarchical
        opts = dict(self.hierarchical) \
            if isinstance(self.hierarchical, dict) else {}
        if c0s is not None:
            opts["c0s"] = c0s
        res = aa_kmeans_hierarchical(
            x, self.n_clusters, cfg, backend=self.backend,
            n_init=max(self.n_init, 1), init=self.init, seed=self.seed,
            metrics=self.metrics, **opts)
        energy = float(res.energy)
        if not math.isfinite(energy):
            raise FloatingPointError(
                f"hierarchical fit produced a non-finite energy "
                f"(E={energy}); check X for NaN/inf rows")
        self.centroids_ = res.centroids
        self.labels_ = res.labels
        self.energy_ = energy
        self.n_iter_ = int(res.n_rounds)
        self.n_accepted_ = None
        self.hier_routers_ = res.routers
        self.hier_offsets_ = res.group_offsets
        return self._refresh_index()

    def _refresh_index(self) -> "AAKMeans":
        """After a fit: drop the stale index, and build a new one when
        ``serving_index`` asks for it."""
        self.closure_routers_ = self.closure_candidates_ = None
        if self.serving_index:
            self.build_serving_index(
                n_candidates=self.serving_index
                if isinstance(self.serving_index, int)
                and not isinstance(self.serving_index, bool) else None)
        return self

    def _assert_fitted(self):
        if self.centroids_ is None:
            raise NotFittedError(
                "this AAKMeans instance has no fitted centroids; call "
                "fit() first")

    def build_serving_index(self, n_candidates: Optional[int] = None,
                            n_groups: Optional[int] = None,
                            seed: int = 0) -> "AAKMeans":
        """Attach a cluster-closure candidate index to the fitted
        centroids (``repro_torch.serving.closure``); ``save`` persists it
        and ``load`` restores it.  After a hierarchical fit, and with no
        sizes given, the index is the fit's own routing, built with no
        clustering."""
        return _build_serving_index(self, n_candidates=n_candidates,
                                    n_groups=n_groups, seed=seed)

    @property
    def closure_index_(self):
        """The fitted ``ClosureIndex``, or None when none was built."""
        return _closure_index(self)

    def predict(self, x, chunk_size: Optional[int] = None,
                approx: bool = False) -> np.ndarray:
        """Nearest-centroid labels (N,) int32 through the backend's
        assignment (the assignment kernel for every kernel backend).
        ``approx=True`` scans only the closure index's candidate
        centroids of each row; without an index it is the exact scan."""
        return _predict_rows(self, x, chunk_size, approx=approx)

    def transform(self, x, chunk_size: Optional[int] = None,
                  approx: bool = False) -> np.ndarray:
        """Distances (N, K) to every centroid; ``approx=True`` prices
        only the candidate centroids (+inf elsewhere)."""
        return _transform_rows(self, x, chunk_size, approx=approx)

    @property
    def inertia_(self) -> float:
        return self.energy_

    # -- persistence ------------------------------------------------------

    def save(self, path):
        """Write params and fitted state (the serving index and a
        hierarchical fit's routing included) to one npz artifact in the
        reference's format (``core/serialize.py``); the reference's
        ``AAKMeans.load`` reads it.  -> the artifact's path."""
        self._assert_fitted()
        arrays = {"centroids_": self.centroids_}
        if self.labels_ is not None:
            arrays["labels_"] = self.labels_
        arrays.update(_index_arrays(self))
        scalars = {"energy_": self.energy_, "n_iter_": self.n_iter_,
                   "n_accepted_": self.n_accepted_}
        return _save_estimator(self, path, serialize.KIND_ESTIMATOR_AA,
                               arrays, {}, scalars)

    @classmethod
    def load(cls, path, device=None) -> "AAKMeans":
        """A fitted estimator from ``save``'s artifact, or the
        reference's, with its tensors on ``device`` (None: CUDA)."""
        model, meta, by_path, dev = _load_estimator(
            cls, path, serialize.KIND_ESTIMATOR_AA, device)
        if "labels_" in meta["has"]:
            model.labels_ = by_path["arrays/labels_"].to(dev)
        return model


class FitInputs(NamedTuple):
    """What ``MiniBatchAAKMeans.fit`` hands its driver."""
    chunks: DeviceChunks         # the training rows, chunked and masked
    x_val: torch.Tensor          # (V, d) the guard's validation chunk
    c0: torch.Tensor             # (K, d) the seeds
    generator: torch.Generator   # CPU generator of the epochs' chunk order


@dataclasses.dataclass
class MiniBatchAAKMeans:
    """Streaming mini-batch AA K-Means estimator.

    Two ways in, over one chunk-step state machine
    (``core/minibatch.py``):

      * ``fit(x)`` — X fits on the device: a random ``val_size``
        validation chunk is held out for the energy guard, the rest is
        chunked, and ``kmeans.aa_kmeans_minibatch`` runs every epoch with
        no sync inside its loop;
      * ``partial_fit(chunk)`` — X does not fit: feed host chunks one at a
        time (``data.streaming.host_chunk_stream``), or a whole iterator
        with its copies prefetched (``partial_fit_stream``).  The first
        call carves its validation chunk out of a uniform draw of its
        rows and seeds the centroids; each call is one chunk step.  When
        making several epochs, re-stream only the rows after the first
        chunk, so the carved validation rows stay held out.

    After ``fit``, ``centroids_`` is the final guard-picked iterate and
    ``energy_`` its validation-chunk energy (the full-X energy is never
    computed).  During a ``partial_fit`` sequence, ``centroids_`` tracks
    the running-stats fallback, ``energy_`` is the guard's pricing of the
    iterate that entered the last step (one step behind) and
    ``n_accepted_`` and ``energy_`` stay on the device, so that no step
    waits for it; ``finalize()`` reprices and applies the guard pick.
    """
    n_clusters: int
    chunk_size: int = 4096
    epochs: int = 5
    decay: float = 0.9
    val_size: int = 1024
    init: str = "kmeans++"
    accelerated: bool = True
    m0: int = 2
    mbar: int = 30
    dynamic_m: bool = True
    eps1: float = 0.02
    eps2: float = 0.5
    ridge: float = 1e-12
    seed: int = 0
    compute_labels: bool = True      # fit() labels the input like sklearn
    # a registry name or a Backend instance, as on AAKMeans
    backend: object = "dense"
    # None means CUDA (RuntimeError without a card); "cpu" runs the
    # kernels' plain versions
    device: object = None
    # a runtime.metrics sink: fit emits per epoch, partial_fit per
    # chunk.  Reading a chunk's
    # scalars waits for its step, a sync the stream otherwise avoids, so
    # attach one only when the diagnostics are worth it.  Not persisted.
    metrics: object = None
    # a DeviceMesh, as on AAKMeans: fit (not partial_fit) and predict run
    # on each rank's shard of the rows
    mesh: object = None
    data_axes: tuple = ("data",)

    # fitted state
    centroids_: Optional[torch.Tensor] = None
    labels_: Optional[np.ndarray] = None
    energy_: object = None
    n_steps_: Optional[int] = None
    n_accepted_: object = None
    closure_routers_: Optional[torch.Tensor] = None
    closure_candidates_: Optional[torch.Tensor] = None

    # streaming state (partial_fit)
    _state: object = dataclasses.field(default=None, repr=False)
    _x_val: object = dataclasses.field(default=None, repr=False)

    def _config(self, chunk_size: Optional[int] = None) -> MiniBatchConfig:
        return MiniBatchConfig(
            k=self.n_clusters, chunk_size=chunk_size or self.chunk_size,
            epochs=self.epochs, decay=self.decay,
            accelerated=self.accelerated,
            aa=AAConfig(m0=self.m0, mbar=self.mbar,
                        dynamic_m=self.dynamic_m,
                        eps1=self.eps1, eps2=self.eps2, ridge=self.ridge))

    def _val_rows(self, n: int) -> int:
        v = min(self.val_size, max(n // 4, self.n_clusters))
        if self.mesh is not None:
            v -= v % shard_count(self.mesh, self.data_axes)
        if v < 1:
            raise ValueError(
                f"cannot carve a validation chunk from N={n} rows "
                f"(val_size={self.val_size})")
        return v

    def fit_inputs(self, x, chunk_size: Optional[int] = None) -> FitInputs:
        """The driver's inputs of ``fit(x)``, drawn as ``fit`` draws them:
        from a generator on the device seeded with ``seed``, the
        validation split, then ``init`` on the first max(chunk_size, 4096)
        training rows (the split shuffles them); the chunk order from a
        CPU generator seeded with ``seed``."""
        return self._fit_inputs(_as_input(x, resolve_device(self.device)),
                                self._config(chunk_size))

    def _fit_inputs(self, x: torch.Tensor, cfg: MiniBatchConfig) -> FitInputs:
        if x.shape[0] < 2 * self.n_clusters:
            raise ValueError(f"need at least {2 * self.n_clusters} rows to "
                             f"fit k={self.n_clusters}; got {x.shape[0]}")
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        x_train, x_val = split_validation(x, self._val_rows(x.shape[0]),
                                          gen)
        n_seed = min(x_train.shape[0], max(cfg.chunk_size, 4096))
        c0 = make_init(self.init)(gen, x_train[:n_seed], self.n_clusters)
        return FitInputs(chunk_dataset(x_train, cfg.chunk_size), x_val, c0,
                         torch.Generator().manual_seed(self.seed))

    def fit(self, x, chunk_size: Optional[int] = None) -> "MiniBatchAAKMeans":
        if self.mesh is not None:
            return self._fit_mesh(x, self._config(chunk_size))
        dev = resolve_device(self.device)
        x = _as_input(x, dev)
        cfg = self._config(chunk_size)
        inputs = self._fit_inputs(x, cfg)
        # a fit supersedes any partial_fit stream in progress: a later
        # partial_fit/finalize would otherwise advance the abandoned
        # stream and overwrite this fit's results
        self._state = self._x_val = None
        res = aa_kmeans_minibatch(
            inputs.chunks.chunks, inputs.chunks.weights, inputs.x_val,
            inputs.c0, cfg, backend=self.backend,
            generator=inputs.generator, device=dev, metrics=self.metrics)
        del inputs
        self.centroids_ = res.centroids
        self.energy_ = float(res.energy)
        self.n_steps_ = int(res.n_steps)
        self.n_accepted_ = int(res.n_accepted)
        # new centroids: an earlier closure index is stale
        self.closure_routers_ = self.closure_candidates_ = None
        self.labels_ = self.predict(x) if self.compute_labels else None
        return self

    def _fit_mesh(self, x, cfg: MiniBatchConfig) -> "MiniBatchAAKMeans":
        """``fit`` on a mesh (the reference's
        ``make_distributed_kmeans_minibatch`` path).  Shard 0 draws what
        the single-device fit draws (the validation split's permutation
        and the seeds, on its device over the global X) and broadcasts
        them; every rank then gathers only its block of each chunk and of
        the validation rows, and takes the chunk order from a CPU
        generator seeded alike."""
        refuse_bf16("a mesh (mesh=)", self.backend, x)
        from repro_torch.core import distributed as D
        dev = mesh_device(self.mesh, self.device)
        axes = tuple(self.data_axes)
        x = _host_array(x)
        n, d = int(x.shape[0]), int(x.shape[1])
        if n < 2 * self.n_clusters:
            raise ValueError(f"need at least {2 * self.n_clusters} rows to "
                             f"fit k={self.n_clusters}; got {n}")
        v = self._val_rows(n)
        self._state = self._x_val = None

        def draws():
            xd = _as_input(x, dev)
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            # split_validation's draw, then the seeding of fit_inputs
            perm = torch.randperm(n, generator=gen, device=dev)
            x_train = xd[perm[v:]]
            n_seed = min(x_train.shape[0], max(cfg.chunk_size, 4096))
            return perm, make_init(self.init)(gen, x_train[:n_seed],
                                              self.n_clusters)

        perm, c0 = D.on_shard_zero(self.mesh, axes, draws, (
            torch.empty((n,), dtype=torch.int64, device=dev),
            torch.empty((self.n_clusters, d), dtype=torch.float32,
                        device=dev)))
        perm = perm.cpu()
        rows = x[perm.to(x.device)].cpu() if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.asarray(x)[perm.numpy()])
        rows = _as_input(rows, torch.device("cpu"))
        dc = chunk_dataset(rows[v:], cfg.chunk_size, mesh=self.mesh,
                           data_axes=axes)
        res = D.make_distributed_kmeans_minibatch(
            self.mesh, cfg, axes, backend=self.backend)(
            dc.chunks, dc.weights, rows[:v], c0,
            torch.Generator().manual_seed(self.seed))
        del dc, rows
        self.centroids_ = res.centroids
        self.energy_ = float(res.energy)
        self.n_steps_ = int(res.n_steps)
        self.n_accepted_ = int(res.n_accepted)
        self.closure_routers_ = self.closure_candidates_ = None
        self.labels_ = self.predict(x) if self.compute_labels else None
        return self

    # -- streaming ---------------------------------------------------------

    def partial_fit(self, chunk) -> "MiniBatchAAKMeans":
        """One chunk step; the device holds no more than this chunk and
        the validation chunk.  ``centroids_`` becomes the fresh
        running-stats iterate and ``energy_`` the guard's pricing of the
        previous one (see the class docstring; ``finalize()`` makes them
        consistent).  A mesh estimator refuses it, as the reference's
        does."""
        if self.mesh is not None:
            raise NotImplementedError(
                "partial_fit streams from one host; for mesh execution "
                "use fit() / make_distributed_kmeans_minibatch")
        bk = resolve_backend(self.backend)
        refuse_bf16("host-streamed chunks (partial_fit)", bk, chunk)
        dev = resolve_device(self.device)
        x = _as_input(chunk, dev)
        cfg = self._config()
        if self._state is None:
            if x.shape[0] < 2 * self.n_clusters:
                raise ValueError(
                    f"the first partial_fit chunk seeds the solver and "
                    f"must have >= {2 * self.n_clusters} rows; got "
                    f"{x.shape[0]}")
            # a uniform carve, not the head: data is often stored sorted,
            # and a validation chunk of the leading cluster only would
            # bias every guard decision
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            x, self._x_val = split_validation(
                x, self._val_rows(x.shape[0]), gen)
            c0 = make_init(self.init)(gen, x, self.n_clusters)
            self._state = minibatch_init(c0, cfg, bk)
        w = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
        self._state, trace = minibatch_iteration(x, w, self._x_val,
                                                 self._state, cfg, bk)
        # device scalars, not float()/int(): a sync per chunk would
        # serialise the stream (the next chunk's copy could no longer
        # overlap this step); fit() and finalize() store Python numbers
        self.centroids_ = self._state.c_au
        self.energy_ = trace.e_val
        self.n_steps_ = self._state.t
        self.n_accepted_ = self._state.n_acc
        # the centroids moved: an earlier closure index is stale
        self.closure_routers_ = self.closure_candidates_ = None
        if self.metrics is not None:
            # a sink opts into a sync per chunk
            e_val, accepted, n_acc = torch.stack([
                trace.e_val.to(torch.float64),
                trace.accepted.to(torch.float64),
                self._state.n_acc.to(torch.float64)]).tolist()
            as_metrics(self.metrics).log_scalars(self._state.t, {
                "e_val": e_val, "accepted": accepted, "n_accepted": n_acc,
                "chunk_rows": float(x.shape[0])})
        return self

    def partial_fit_stream(self, chunks, prefetch: int = 2
                           ) -> "MiniBatchAAKMeans":
        """Consume an iterator of host chunks with their host-to-device
        copies prefetched (``data.streaming.stream_chunks``): chunk t+1's
        copy is issued while chunk t's step runs.  Equal bit for bit to
        calling ``partial_fit`` per chunk.  With a ``metrics`` sink, the
        stream's ingest totals (``IngestMeter.scalars``) are emitted at
        its end."""
        dev = resolve_device(self.device)
        meter = None if self.metrics is None else IngestMeter()
        for chunk in stream_chunks(iter(chunks), prefetch=prefetch,
                                   device=dev, meter=meter):
            self.partial_fit(chunk)
        if meter is not None and meter.chunks:
            as_metrics(self.metrics).log_scalars(self._state.t,
                                                 meter.scalars())
        return self

    def finalize(self) -> "MiniBatchAAKMeans":
        """The guard's pick between the accelerated candidate and the
        running-stats fallback after a partial_fit sequence (fit() applies
        it itself)."""
        if self._state is None:
            raise ValueError("no streaming state; call partial_fit first")
        c_fin, e_fin, _, _ = guard_pick(self._x_val, self._state,
                                        self._config(),
                                        resolve_backend(self.backend))
        self.centroids_ = c_fin
        self.energy_ = float(e_fin)
        self.closure_routers_ = self.closure_candidates_ = None
        return self

    # -- inference ---------------------------------------------------------

    def _assert_fitted(self):
        if self.centroids_ is None:
            raise NotFittedError(
                "this MiniBatchAAKMeans instance has no fitted centroids; "
                "call fit() or partial_fit() first")

    def build_serving_index(self, n_candidates: Optional[int] = None,
                            n_groups: Optional[int] = None,
                            seed: int = 0) -> "MiniBatchAAKMeans":
        """Attach a cluster-closure candidate index to the fitted
        centroids; ``save`` persists it and ``load`` restores it.  A
        later fit, partial_fit or finalize drops it."""
        return _build_serving_index(self, n_candidates=n_candidates,
                                    n_groups=n_groups, seed=seed)

    @property
    def closure_index_(self):
        """The fitted ``ClosureIndex``, or None when none was built."""
        return _closure_index(self)

    def predict(self, x, chunk_size: Optional[int] = None,
                approx: bool = False) -> np.ndarray:
        """Nearest-centroid labels (N,) int32, chunk by chunk into a host
        array through the backend's assignment; ``approx=True`` through
        the closure index, as on ``AAKMeans``."""
        return _predict_rows(self, x, chunk_size, approx=approx)

    def transform(self, x, chunk_size: Optional[int] = None,
                  approx: bool = False) -> np.ndarray:
        """Distances (N, K) to every centroid; ``approx=True`` as on
        ``AAKMeans``."""
        return _transform_rows(self, x, chunk_size, approx=approx)

    @property
    def inertia_(self):
        return self.energy_

    # -- persistence ------------------------------------------------------

    def save(self, path):
        """Write params and fitted state — an in-progress ``partial_fit``
        stream included (running stats, Anderson window, guard energies,
        the carved validation chunk) — to one npz artifact in the
        reference's layout.  A loaded mid-stream model continues the
        stream where this one stopped: fed the same remaining chunks it
        ends bit for bit where this one would.  -> the artifact's path."""
        self._assert_fitted()
        arrays = {"centroids_": self.centroids_}
        if self.labels_ is not None:
            arrays["labels_"] = self.labels_
        arrays.update(_index_arrays(self))
        stream = {}
        if self._state is not None:
            stream = {"state": reference_layout(self._state),
                      "x_val": self._x_val}
        # mid-stream, energy_ and n_accepted_ are device scalars
        scalars = {"energy_": _host_number(self.energy_, float),
                   "n_steps_": _host_number(self.n_steps_, int),
                   "n_accepted_": _host_number(self.n_accepted_, int)}
        return _save_estimator(self, path, serialize.KIND_ESTIMATOR_MB,
                               arrays, stream, scalars)

    @classmethod
    def load(cls, path, device=None) -> "MiniBatchAAKMeans":
        """An estimator from ``save``'s artifact, or the reference's, with
        its tensors on ``device`` (None: CUDA); a saved mid-stream state
        is restored, so the next ``partial_fit`` / ``finalize`` continues
        the stream."""
        model, meta, by_path, dev = _load_estimator(
            cls, path, serialize.KIND_ESTIMATOR_MB, device)
        if "labels_" in meta["has"]:
            model.labels_ = by_path["arrays/labels_"].numpy()
        if meta["has_stream"]:
            # the state's structure, dtypes and shapes from the port's own
            # init, on the meta device
            c = torch.empty(by_path["stream/state/c"].shape, device="meta")
            like = {"state": reference_layout(minibatch_init(
                        c, model._config(), resolve_backend(model.backend))),
                    "x_val": torch.empty(by_path["stream/x_val"].shape,
                                         device="meta")}
            tree = serialize.fill(by_path, like, prefix="stream/",
                                  device=dev, path=path)
            model._state = from_reference_layout(tree["state"])
            model._x_val = tree["x_val"]
        return model
