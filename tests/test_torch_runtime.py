"""The port's host runtime against the JAX package's: the metrics sinks
(``runtime/metrics.py``), the checkpoint writer with its manifest,
retention and orphan sweep (``runtime/writer.py``),
``checkpoint.latest_snapshot`` / ``resume_point``, the prefetcher's
accounting, and their wiring through the segmented drivers (the
counterparts of ``tests/test_runtime.py``'s sink, writer and driver
tests).

Inputs are numpy from a seed.  The port runs on the CPU (its kernel
engines run their plain versions).  Tolerances: the port against itself
(async against synchronous writes, a resumed run against the
uninterrupted one) bit for bit, artifacts compared member by member,
byte for byte (the npz's zip headers carry a write time, so whole files
are compared only through their members); a snapshot written by both
packages' ``write_snapshot`` from one numpy tree has byte-equal members
and equal manifests.
"""

import json
import sys
import threading
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.writer import read_manifest as jread_manifest
from repro.runtime.writer import write_snapshot as jwrite_snapshot
from repro_torch.checkpoint import latest_snapshot, resume_point
from repro_torch.core import AAKMeans, MiniBatchAAKMeans, serialize
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     aa_kmeans_minibatch_streamed,
                                     aa_kmeans_traced)
from repro_torch.core.minibatch import MiniBatchConfig
from repro_torch.data.streaming import chunk_dataset
from repro_torch.data.synthetic import make_blobs
from repro_torch.interop import estimator_kwargs
from repro_torch.runtime.metrics import (CollectMetrics, EarlyStopHook,
                                         JsonlMetrics, NullMetrics,
                                         StdoutMetrics, TeeMetrics,
                                         as_metrics, should_stop)
from repro_torch.runtime.prefetch import (IngestMeter, prefetch_to_device,
                                          tree_nbytes)
from repro_torch.runtime.writer import (CheckpointWriter, cleanup_orphans,
                                        read_manifest, snapshot_name,
                                        write_snapshot)

torch.set_num_threads(2)


def _problem(n=400, d=4, k=5, max_iter=30, seed=0):
    """Blobs, seeds drawn from its rows, and the config."""
    x = torch.from_numpy(make_blobs(n, d, k, seed=seed, spread=1.0))
    idx = np.random.default_rng(seed).permutation(n)[:k]
    return x, x[idx].clone(), KMeansConfig(k=k, max_iter=max_iter)


def _members(path) -> dict:
    """Each npz member's bytes (npy headers and data, the meta blob)."""
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _same_result(a, b) -> bool:
    return all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
               for u, v in zip(a, b))


# -- sinks --------------------------------------------------------------------

def test_as_metrics_normalisation():
    assert isinstance(as_metrics(None), NullMetrics)
    assert isinstance(as_metrics("null"), NullMetrics)
    assert isinstance(as_metrics("stdout"), StdoutMetrics)
    sink = CollectMetrics()
    assert as_metrics(sink) is sink
    with pytest.raises(ValueError, match="unknown metrics sink"):
        as_metrics("wandb")
    with pytest.raises(TypeError, match="log_scalars"):
        as_metrics(42)


def test_collect_and_tee_and_jsonl(tmp_path):
    c1, c2 = CollectMetrics(), CollectMetrics()
    jl = JsonlMetrics(tmp_path / "m.jsonl")
    tee = TeeMetrics(c1, c2, jl)
    tee.log_scalars(1, {"e": torch.tensor(2.5), "n": 3,
                        "b": torch.tensor(True)})
    tee.log_scalars(2, {"e": np.float32(1.25)})
    tee.close()
    assert c1.records == c2.records == [(1, {"e": 2.5, "n": 3.0, "b": 1.0}),
                                        (2, {"e": 1.25})]
    lines = [json.loads(ln) for ln in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert lines == [{"step": 1, "e": 2.5, "n": 3.0, "b": 1.0},
                     {"step": 2, "e": 1.25}]


def test_stdout_sink_line(capsys):
    StdoutMetrics(prefix="run").log_scalars(
        4, {"segment_s": 0.5, "energy": torch.tensor(12.0)})
    assert capsys.readouterr().out == "run step=4 energy=12 segment_s=0.5\n"


def test_early_stop_hook_trips_on_stall():
    hook = EarlyStopHook(rel_tol=1e-3, patience=2, min_records=1)
    hook.log_scalars(0, {"energy": 100.0})
    hook.log_scalars(1, {"energy": 50.0})     # a large improvement
    assert not hook.should_stop
    hook.log_scalars(2, {"energy": 49.999})   # stall 1
    assert not hook.should_stop
    hook.log_scalars(3, {"energy": 49.998})   # stall 2: stop
    assert hook.should_stop and hook.stopped_at == 3
    assert should_stop(hook)
    hook.log_scalars(4, {"energy": 1.0})      # never resets
    assert hook.should_stop
    assert len(hook.records) == 5


def test_early_stop_hook_metric_fallbacks_and_nonfinite():
    hook = EarlyStopHook(rel_tol=1e-3, patience=1, min_records=1)
    hook.log_scalars(0, {"segment_s": 0.5})            # no watched metric
    hook.log_scalars(1, {"e_val": float("nan")})       # ignored
    hook.log_scalars(2, {"energy_best": torch.tensor(10.0)})
    assert not hook.should_stop
    hook.log_scalars(3, {"energy_best": 10.0})
    assert hook.should_stop
    assert not should_stop(CollectMetrics())
    assert should_stop(TeeMetrics(CollectMetrics(), hook))


def _halted(driver, tmp_path):
    """(halted result, uninterrupted result) of one segmented driver
    whose EarlyStopHook asks for an impossible improvement."""
    hook = EarlyStopHook(rel_tol=10.0, patience=1, min_records=1)
    if driver == "minibatch":
        x, c0, _ = _problem(n=1200, k=5)
        dc = chunk_dataset(x[200:], 100)
        cfg = MiniBatchConfig(k=5, chunk_size=100, epochs=6)

        def run(**kw):
            return aa_kmeans_minibatch(dc.chunks, dc.weights, x[:200], c0,
                                       cfg, device="cpu", **kw)
        return run(metrics=hook), run(), hook
    x, c0, cfg = _problem(max_iter=200)
    if driver == "single":
        return (aa_kmeans(x, c0, cfg, checkpoint_every=1, metrics=hook),
                aa_kmeans(x, c0, cfg), hook)
    c0s = torch.stack([c0, x[:5]])
    return (aa_kmeans_batched(x, c0s, cfg, checkpoint_every=1, metrics=hook),
            aa_kmeans_batched(x, c0s, cfg), hook)


@pytest.mark.parametrize("driver", ["single", "batched", "minibatch"])
def test_early_stop_hook_halts_segmented_driver(driver, tmp_path):
    halted, full, hook = _halted(driver, tmp_path)
    assert hook.should_stop and hook.stopped_at is not None
    if driver == "minibatch":
        assert halted.n_steps < full.n_steps
    else:
        assert int(torch.max(halted.n_iter)) < int(torch.max(full.n_iter))


def test_jsonl_is_thread_safe(tmp_path):
    jl = JsonlMetrics(tmp_path / "m.jsonl")
    errors = []

    def pump(tid):
        try:
            for i in range(50):
                jl.log_scalars(i, {"tid": tid, "i": i})
        except BaseException as e:   # noqa: BLE001 -- reported below
            errors.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=pump, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    jl.close()
    recs = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert sorted((r["tid"], r["i"]) for r in recs) == \
        [(t, i) for t in range(8) for i in range(50)]


# -- writer: manifest, retention, orphans ------------------------------------

def _fake_state(step):
    return {"c": torch.full((3, 2), float(step)),
            "t": torch.tensor(step, dtype=torch.int32)}


def test_write_snapshot_builds_manifest(tmp_path):
    for t in (2, 4, 6):
        write_snapshot(tmp_path, _fake_state(t), kind="unit", step=t,
                       extra={"t": t})
    m = read_manifest(tmp_path)
    assert m is not None and m["kind"] == "unit"
    assert m["schema"] == "ckpt_manifest/v1"
    assert m["latest"] == snapshot_name(6) == "it_00000006.npz"
    assert [e["step"] for e in m["snapshots"]] == [2, 4, 6]
    assert (tmp_path / m["latest"]).exists()


def test_write_snapshot_matches_the_reference(tmp_path):
    """One numpy tree through both packages' write_snapshot, with
    retention: the same files, byte-equal members, equal manifests."""
    rng = np.random.default_rng(0)
    states = {t: {"c": rng.standard_normal((4, 3)).astype(np.float32),
                  "n": np.asarray(t, np.int32)} for t in (5, 10, 15, 20)}
    for t, st in states.items():
        extra = {"t": t, "k": 4, "backend": "dense"}
        write_snapshot(tmp_path / "port", st, kind="loop_state", step=t,
                       extra=extra, keep_last_n=2, keep_every_m=10)
        jwrite_snapshot(tmp_path / "ref", {k: jnp.asarray(v)
                                           for k, v in st.items()},
                        kind="loop_state", step=t, extra=extra,
                        keep_last_n=2, keep_every_m=10)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in names:
        if name.endswith(".npz"):
            assert _members(tmp_path / "port" / name) == \
                _members(tmp_path / "ref" / name)
    assert read_manifest(tmp_path / "port") == \
        jread_manifest(tmp_path / "ref")


def test_retention_window_and_boundary_keep(tmp_path):
    # keep_last_n=2 with keep_every_m=10: the newest two plus every 10th
    for t in range(5, 55, 5):
        write_snapshot(tmp_path, _fake_state(t), kind="unit", step=t,
                       keep_last_n=2, keep_every_m=10)
    kept = sorted(p.name for p in tmp_path.glob("it_*.npz"))
    want = sorted({snapshot_name(t) for t in (10, 20, 30, 40, 50, 45)})
    assert kept == want
    m = read_manifest(tmp_path)
    assert sorted(e["file"] for e in m["snapshots"]) == want
    for e in m["snapshots"]:
        assert (tmp_path / e["file"]).exists()


def test_retention_always_keeps_newest(tmp_path):
    for t in (3, 6, 10, 13):
        write_snapshot(tmp_path, _fake_state(t), kind="unit", step=t,
                       keep_every_m=10)
    kept = {p.name for p in tmp_path.glob("it_*.npz")}
    assert kept == {snapshot_name(10), snapshot_name(13)}


def test_cleanup_orphans(tmp_path):
    (tmp_path / "it_00000001.npz.tmp").write_bytes(b"partial")
    (tmp_path / "manifest.json.tmp").write_bytes(b"{")
    keep = tmp_path / "it_00000002.npz"
    keep.write_bytes(b"complete")
    removed = cleanup_orphans(tmp_path)
    assert len(removed) == 2 and keep.exists()
    assert not list(tmp_path.glob("*.tmp"))
    assert cleanup_orphans(tmp_path / "absent") == []


def test_latest_snapshot_uses_manifest_with_scan_fallback(tmp_path):
    assert latest_snapshot(tmp_path / "absent") is None
    assert resume_point(tmp_path) == (None, None)
    for t in (1, 2):
        write_snapshot(tmp_path, _fake_state(t), kind="unit", step=t,
                       extra={"t": t})
    assert latest_snapshot(tmp_path).name == snapshot_name(2)
    p, meta = resume_point(tmp_path)
    assert p.name == snapshot_name(2) and meta["t"] == 2
    # an unreadable manifest: the scan still finds the newest artifact
    (tmp_path / "manifest.json").write_text("not json")
    assert latest_snapshot(tmp_path).name == snapshot_name(2)
    # a manifest naming a file deleted from outside: the scan too
    write_snapshot(tmp_path, _fake_state(3), kind="unit", step=3)
    (tmp_path / snapshot_name(3)).unlink()
    assert latest_snapshot(tmp_path).name == snapshot_name(2)


def test_latest_snapshot_fallback_orders_by_step_not_name(tmp_path):
    for step in (9, 10, 2):
        (tmp_path / f"it_{step}.npz").write_bytes(b"snap")
    (tmp_path / "it_11.npz.tmp").write_bytes(b"orphan")
    (tmp_path / "it_xx.npz").write_bytes(b"garbage")
    assert latest_snapshot(tmp_path).name == "it_10.npz"
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "it_1.npz.tmp").write_bytes(b"orphan")
    assert latest_snapshot(empty) is None


# -- writer: the thread -------------------------------------------------------

def test_writer_async_matches_sync_artifacts(tmp_path):
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    states = {t: _fake_state(t) for t in (1, 2, 3)}
    for t, st in states.items():
        write_snapshot(sync_dir, st, kind="unit", step=t, extra={"t": t})
    with CheckpointWriter(async_dir, kind="unit") as w:
        for t, st in states.items():
            w.submit(st, t, {"t": t})
    assert w.n_written == 3
    for t in states:
        assert _members(sync_dir / snapshot_name(t)) == \
            _members(async_dir / snapshot_name(t))
        meta, by_path = serialize.load(async_dir / snapshot_name(t))
        assert meta["t"] == t and int(by_path["t"]) == t
    assert read_manifest(sync_dir) == read_manifest(async_dir)


def _fail(*args, **kwargs):
    raise OSError("disk full")


def test_writer_propagates_write_errors(tmp_path, monkeypatch):
    import repro_torch.runtime.writer as W
    w = CheckpointWriter(tmp_path, kind="unit")
    monkeypatch.setattr(W, "write_snapshot", _fail)
    w.submit(_fake_state(1), 1)
    with pytest.raises(OSError, match="disk full"):
        w.drain()
    w.close()    # the error was raised once, close is clean


def test_writer_raises_on_the_next_submit(tmp_path, monkeypatch):
    import repro_torch.runtime.writer as W
    monkeypatch.setattr(W, "write_snapshot", _fail)
    w = CheckpointWriter(tmp_path, kind="unit", queue_size=1)
    w.submit(_fake_state(1), 1)
    w._q.join()
    with pytest.raises(OSError, match="disk full"):
        w.submit(_fake_state(2), 2)
    w.close()


def test_writer_emits_write_latency_metric(tmp_path):
    mx = CollectMetrics()
    with CheckpointWriter(tmp_path, kind="unit", metrics=mx) as w:
        w.submit(_fake_state(7), 7)
    assert any(step == 7 and rec["checkpoint_write_s"] >= 0
               for step, rec in mx.records)
    assert w.last_write_s is not None


def test_writer_refuses_submit_after_close(tmp_path):
    w = CheckpointWriter(tmp_path, kind="unit")
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(_fake_state(1), 1)
    w.close()      # idempotent
    assert not w._thread.is_alive()


def test_writer_drains_when_the_body_raises(tmp_path):
    with pytest.raises(KeyError):
        with CheckpointWriter(tmp_path, kind="unit") as w:
            for t in (1, 2, 3):
                w.submit(_fake_state(t), t)
            raise KeyError("the body's own error")
    assert w.n_written == 3
    assert read_manifest(tmp_path)["latest"] == snapshot_name(3)


# -- the prefetcher's accounting ---------------------------------------------

def test_prefetch_meter_counts_bytes_and_gives_scalars(rng):
    chunks = [rng.standard_normal((16, 4)).astype(np.float32)
              for _ in range(5)]
    meter = IngestMeter()
    out = list(prefetch_to_device(iter(chunks), size=2, device="cpu",
                                  meter=meter))
    assert meter.chunks == 5
    assert meter.bytes == 5 * 16 * 4 * 4 == sum(map(tree_nbytes, chunks)) \
        == tree_nbytes(out)
    sc = meter.scalars()
    assert sc["ingest_bytes"] == 1280.0 and sc["ingest_chunks"] == 5.0
    assert sc["ingest_gbps"] > 0


def test_tree_nbytes_walks_trees():
    tree = {"a": torch.zeros((2, 3)), "b": (np.zeros(4, np.int32), None),
            "c": [torch.zeros((), dtype=torch.bool)]}
    assert tree_nbytes(tree) == 24 + 16 + 1


# -- the drivers --------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_driver_async_checkpoints_match_sync(tmp_path, backend):
    x, c0, cfg = _problem()
    ref = aa_kmeans(x, c0, cfg, backend=backend)
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    aa_kmeans(x, c0, cfg, backend=backend, checkpoint_every=3,
              checkpoint_dir=sync_dir, sync_writes=True)
    aa_kmeans(x, c0, cfg, backend=backend, checkpoint_every=3,
              checkpoint_dir=async_dir)
    names = sorted(p.name for p in sync_dir.glob("it_*.npz"))
    assert names == sorted(p.name for p in async_dir.glob("it_*.npz"))
    assert len(names) >= 2
    for name in names:
        assert _members(sync_dir / name) == _members(async_dir / name)
    assert read_manifest(sync_dir) == read_manifest(async_dir)
    res = aa_kmeans(x, c0, cfg, backend=backend,
                    resume_from=latest_snapshot(async_dir))
    assert _same_result(res, ref)


def test_driver_killed_midrun_resumes_from_manifest(tmp_path):
    """A run that dies at a boundary still drains its writer, so the
    manifest names a snapshot on disk, and the run resumed from it ends
    where the uninterrupted one does, bit for bit."""
    x, c0, cfg = _problem(max_iter=40)
    ref = aa_kmeans(x, c0, cfg)

    class Die(RuntimeError):
        pass

    boundaries = []

    def killer(state, t):
        boundaries.append(t)
        if len(boundaries) >= 2:
            raise Die("preempted")

    with pytest.raises(Die):
        aa_kmeans(x, c0, cfg, checkpoint_every=3, checkpoint_dir=tmp_path,
                  checkpoint_cb=killer)
    p, meta = resume_point(tmp_path)
    assert p is not None and meta["t"] == boundaries[-1] == 6
    assert meta["k"] == cfg.k and meta["backend"] == "dense"
    assert read_manifest(tmp_path)["latest"] == p.name
    assert _same_result(aa_kmeans(x, c0, cfg, resume_from=p), ref)


def test_driver_failed_write_fails_run(tmp_path, monkeypatch):
    import repro_torch.runtime.writer as W
    x, c0, cfg = _problem()
    monkeypatch.setattr(W, "write_snapshot", _fail)
    with pytest.raises(OSError, match="disk full"):
        aa_kmeans(x, c0, cfg, checkpoint_every=5, checkpoint_dir=tmp_path)


def test_driver_retention_flows_through(tmp_path):
    x, c0, cfg = _problem(max_iter=40)
    aa_kmeans(x, c0, cfg, checkpoint_every=2, checkpoint_dir=tmp_path,
              keep_last_n=2)
    snaps = sorted(tmp_path.glob("it_*.npz"))
    assert len(snaps) == 2
    assert len(read_manifest(tmp_path)["snapshots"]) == 2
    res = aa_kmeans(x, c0, cfg, resume_from=snaps[-1])
    assert _same_result(res, aa_kmeans(x, c0, cfg))


def test_driver_metrics_emission(tmp_path):
    x, c0, cfg = _problem()
    mx = CollectMetrics()
    res = aa_kmeans(x, c0, cfg, backend="fused_bounds", checkpoint_every=3,
                    checkpoint_dir=tmp_path, metrics=mx)
    seg = [(s, r) for s, r in mx.records if "energy" in r]
    assert [s for s, _ in seg] == sorted(s for s, _ in seg) and seg
    for _, rec in seg:
        assert {"energy", "n_accepted", "converged", "segment_s",
                "snapshot_s", "eliminated_frac", "skipped_frac"} <= set(rec)
    assert seg[-1][1]["energy"] == float(res.energy)
    assert seg[-1][1]["n_accepted"] == float(res.n_accepted)
    # the writer's latencies go to the same sink
    assert sum("checkpoint_write_s" in r for _, r in mx.records) == len(seg)


# -- metrics= on the other entry points --------------------------------------

def test_aakmeans_metrics_fit_equals_the_sink_free_fit(tmp_path):
    x = make_blobs(600, 4, 5, seed=2, spread=1.0)
    mx = CollectMetrics()
    plain = AAKMeans(n_clusters=5, n_init=2, backend="fused",
                     device="cpu").fit(x)
    sunk = AAKMeans(n_clusters=5, n_init=2, backend="fused", device="cpu",
                    metrics=mx).fit(x)
    assert torch.equal(plain.centroids_, sunk.centroids_)
    assert torch.equal(plain.labels_, sunk.labels_)
    assert (plain.energy_, plain.n_iter_, plain.n_accepted_) == \
        (sunk.energy_, sunk.n_iter_, sunk.n_accepted_)
    assert mx.records and {"energy_best", "n_active", "n_accepted_total",
                           "segment_s"} <= set(mx.records[-1][1])
    assert mx.records[-1][1]["n_active"] == 0.0
    # a sink belongs to the process: it is not persisted
    meta, _ = serialize.load(sunk.save(tmp_path / "m"))
    assert "metrics" not in meta["params"] and "device" not in meta["params"]
    assert AAKMeans.load(tmp_path / "m.npz", device="cpu").metrics is None


def test_minibatch_estimator_metrics(tmp_path):
    x = make_blobs(1500, 4, 5, seed=2)
    kw = dict(n_clusters=5, chunk_size=128, epochs=3, val_size=128,
              backend="fused", device="cpu")
    mx = CollectMetrics()
    plain = MiniBatchAAKMeans(**kw).fit(x)
    sunk = MiniBatchAAKMeans(metrics=mx, **kw).fit(x)
    assert torch.equal(plain.centroids_, sunk.centroids_)
    assert plain.energy_ == sunk.energy_
    assert [s for s, _ in mx.records] == [1, 2, 3]
    assert {"e_val", "e_cand", "e_fallback", "n_accepted_epoch",
            "epoch_s"} <= set(mx.records[0][1])
    # partial_fit emits per chunk, partial_fit_stream its ingest at the end
    mx = CollectMetrics()
    stream = MiniBatchAAKMeans(metrics=mx, **kw)
    chunks = [x[i:i + 300] for i in range(0, 1500, 300)]
    stream.partial_fit_stream(chunks)
    per_chunk = [r for _, r in mx.records if "e_val" in r]
    assert [s for s, r in mx.records if "e_val" in r] == [1, 2, 3, 4, 5]
    # the first chunk's validation rows are carved out of it
    assert per_chunk[0]["chunk_rows"] == 300 - stream._x_val.shape[0]
    assert [r["chunk_rows"] for r in per_chunk[1:]] == [300.0] * 4
    assert per_chunk[-1]["n_accepted"] == float(stream.n_accepted_)
    step, ingest = mx.records[-1]
    assert step == 5 and ingest["ingest_chunks"] == 5.0
    assert ingest["ingest_bytes"] == float(x.nbytes)
    meta, _ = serialize.load(stream.save(tmp_path / "s"))
    assert "metrics" not in meta["params"]


def test_reference_params_carry_the_sink_across():
    mx = CollectMetrics()
    kw = estimator_kwargs(AAKMeans, {"n_clusters": 3, "metrics": mx,
                                     "mesh": None}, device="cpu")
    assert kw["metrics"] is mx and "mesh" not in kw


def test_traced_driver_emits_every_iteration():
    x, c0, cfg = _problem(max_iter=40)
    mx = CollectMetrics()
    tr = aa_kmeans_traced(x, c0, cfg, backend="fused_bounds", metrics=mx)
    plain = aa_kmeans_traced(x, c0, cfg, backend="fused_bounds")
    assert _same_result(tr.result, plain.result)
    assert [s for s, _ in mx.records] == list(range(1, len(tr.energies) + 1))
    for (_, rec), e, m, a, bs in zip(mx.records, tr.energies, tr.m_values,
                                     tr.accepted, tr.bound_stats):
        assert rec == {"energy": e, "m": float(m), "accepted": float(a),
                       **bs}


def test_streamed_driver_emits_every_chunk():
    x = make_blobs(1300, 4, 5, seed=3)
    x_val, rows = torch.from_numpy(x[:200]), x[200:]
    c0 = x_val[:5].clone()
    cfg = MiniBatchConfig(k=5, chunk_size=100, epochs=2)
    mx = CollectMetrics()
    kw = dict(backend="fused", drop_remainder=True, device="cpu")
    plain = aa_kmeans_minibatch_streamed(rows, x_val, c0, cfg, **kw)
    sunk = aa_kmeans_minibatch_streamed(rows, x_val, c0, cfg, metrics=mx,
                                        **kw)
    assert _same_result(plain, sunk)
    assert [s for s, _ in mx.records] == list(range(1, 23))
    assert sum(r["accepted"] for _, r in mx.records) == \
        float(sunk.n_accepted)
