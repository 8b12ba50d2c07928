"""The port's chunk pipeline against the JAX package's: the data layer
(``chunk_dataset``, ``split_validation``, ``host_chunk_stream``,
``stream_chunks`` with ``sort_by=``), the prefetcher
(``runtime/prefetch.py``), the streamed driver
``aa_kmeans_minibatch_streamed`` and a tiny run of
``benchmarks_torch/streaming_sweep.py``.

The host stream is the reference's numpy code, so its chunks are equal
bit for bit; the prefetcher yields its input sequence, so a prefetched
run equals a synchronous one bit for bit.  The streamed driver is held
to the reference's on the same chunks at the solver's tolerances (step
counts and accept decisions exact, centroids and energies within 1e-5
relative).  Everything here runs on the CPU (``device="cpu"``); the
card's pinned, side-stream path is tested in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import \
    aa_kmeans_minibatch_streamed as jaa_kmeans_minibatch_streamed
from repro.core.minibatch import MiniBatchConfig as JMiniBatchConfig
from repro.data import streaming as jstreaming
from repro.data.synthetic import make_blobs
from repro_torch.core import MiniBatchConfig
from repro_torch.core.kmeans import aa_kmeans_minibatch_streamed
from repro_torch.data.streaming import (DeviceChunks, chunk_dataset,
                                        host_chunk_stream, split_validation,
                                        stream_chunks)
from repro_torch.runtime import IngestMeter, prefetch_to_device

torch.set_num_threads(2)

K, D = 8, 8


@pytest.fixture(scope="module")
def problem():
    """(x_train, x_val, c0): blobs, 256 validation rows, the reference's
    K-Means++ seeds."""
    x = make_blobs(4000, D, K, seed=1, spread=3.0)
    c0 = np.array(jkmeanspp(jax.random.PRNGKey(1), jnp.asarray(x[256:2304]),
                            K))
    return x[256:], x[:256], c0


# -- the data layer ------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(chunk_size=600, epochs=2, seed=3),
    dict(chunk_size=600, epochs=2, seed=3, drop_remainder=True),
    dict(chunk_size=512, epochs=3, seed=0, start_chunk=5),
    dict(chunk_size=1000, epochs=1, seed=9, drop_remainder=True,
         start_chunk=2)], ids=["tail", "drop", "start", "drop-start"])
def test_host_chunk_stream_matches_jax(problem, opts):
    x = problem[0]
    got = list(host_chunk_stream(x, **opts))
    want = list(jstreaming.host_chunk_stream(x, **opts))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_chunk_stream_reshuffles_per_epoch():
    x = np.arange(100, dtype=np.float32).reshape(100, 1)
    chunks = list(host_chunk_stream(x, 32, epochs=2, seed=0))
    assert [c.shape[0] for c in chunks] == [32, 32, 32, 4] * 2
    e1 = np.concatenate([c.ravel() for c in chunks[:4]])
    e2 = np.concatenate([c.ravel() for c in chunks[4:]])
    np.testing.assert_array_equal(np.sort(e1), x.ravel())
    np.testing.assert_array_equal(np.sort(e2), x.ravel())
    assert not (e1 == e2).all()


def test_chunk_dataset_matches_jax_and_masks_the_tail():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    dc = chunk_dataset(torch.from_numpy(x), 4)
    jdc = jstreaming.chunk_dataset(jnp.asarray(x), 4)
    assert dc.chunks.shape == (3, 4, 3) and dc.n == jdc.n == 10
    np.testing.assert_array_equal(dc.chunks.numpy(), np.asarray(jdc.chunks))
    np.testing.assert_array_equal(dc.weights.numpy(),
                                  [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]])
    np.testing.assert_array_equal(dc.chunks[2, 3].numpy(), x[-1])
    exact = chunk_dataset(torch.from_numpy(x), 5)
    assert exact.chunks.shape == (2, 5, 3) and bool(exact.weights.all())
    with pytest.raises(ValueError, match="chunk_size"):
        chunk_dataset(torch.from_numpy(x), 0)


def test_split_validation_partitions():
    x = torch.arange(100 * 2, dtype=torch.float32).reshape(100, 2)
    gen = torch.Generator().manual_seed(0)
    xt, xv = split_validation(x, 25, gen)
    assert xt.shape == (75, 2) and xv.shape == (25, 2)
    merged = torch.cat([xt, xv])
    assert torch.equal(merged[torch.argsort(merged[:, 0])], x)
    # drawn from the generator: the same seed gives the same split
    xt2, xv2 = split_validation(x, 25, torch.Generator().manual_seed(0))
    assert torch.equal(xv, xv2) and torch.equal(xt, xt2)
    for bad in (0, 100):
        with pytest.raises(ValueError, match="val_size"):
            split_validation(x, bad, gen)


@pytest.mark.parametrize("callable_sort", [False, True],
                         ids=["array", "callable"])
def test_stream_chunks_sort_by_matches_jax(problem, callable_sort):
    x, _, c0 = problem
    sort_by = (lambda: c0) if callable_sort else c0
    opts = dict(epochs=2, seed=4, prefetch=2, sort_by=sort_by)
    got = list(stream_chunks(x, 700, device="cpu", **opts))
    want = list(jstreaming.stream_chunks(x, 700, **opts))
    assert len(got) == len(want) == 2 * -(-x.shape[0] // 700)
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # each chunk comes sorted by its nearest seed
    rows = got[0].numpy()
    lab = np.argmin(((rows[:, None, :] - c0[None]) ** 2).sum(-1), axis=1)
    assert (np.diff(lab) >= 0).all()


def test_stream_chunks_device_source(problem):
    dc = chunk_dataset(torch.from_numpy(problem[0]), 512)
    got = list(stream_chunks(dc))
    assert len(got) == dc.chunks.shape[0]
    assert all(torch.equal(a, b) for a, b in zip(got, dc.chunks))
    for bad in (dict(chunk_size=4), dict(epochs=2), dict(seed=1),
                dict(start_chunk=1), dict(drop_remainder=True),
                dict(sort_by=problem[2])):
        with pytest.raises(ValueError, match="storage order"):
            stream_chunks(dc, **bad)
    with pytest.raises(ValueError, match="chunk_size is required"):
        stream_chunks(problem[0], device="cpu")
    assert isinstance(dc, DeviceChunks)


# -- the prefetcher ------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_yields_the_input_sequence_and_meters_it(size):
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(n, 5)).astype(np.float32)
              for n in (64, 64, 64, 17)]
    meter = IngestMeter()
    got = list(prefetch_to_device(iter(chunks), size=size, device="cpu",
                                  meter=meter))
    assert len(got) == len(chunks)
    for a, b in zip(got, chunks):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert meter.chunks == len(chunks)
    assert meter.bytes == sum(c.nbytes for c in chunks)
    assert len(meter.fetch_s) == len(meter.stage_s) == len(chunks)
    assert meter.copy_ms() == [] and meter.gbps > 0


def test_prefetch_narrows_float64_and_rejects_size_zero():
    got = list(prefetch_to_device([np.ones((3, 2))], device="cpu"))
    assert got[0].dtype == torch.float32
    with pytest.raises(ValueError, match="prefetch size"):
        list(prefetch_to_device(iter([np.ones((3, 2))]), size=0,
                                device="cpu"))


def test_prefetch_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter([np.ones((3, 2), np.float32)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aa_kmeans_minibatch_streamed(np.ones((64, 2), np.float32),
                                     torch.ones(8, 2), torch.ones(2, 2),
                                     MiniBatchConfig(k=2, chunk_size=16))


# -- the streamed driver -------------------------------------------------------

def test_streamed_driver_matches_jax(problem):
    """The same host chunks (drop_remainder: one shape) through both
    drivers, 2 epochs from the same seeds."""
    x, x_val, c0 = problem
    jcfg = JMiniBatchConfig(k=K, chunk_size=512, epochs=2)
    jres, jtr = jaa_kmeans_minibatch_streamed(
        x, jnp.asarray(x_val), jnp.asarray(c0), jcfg, backend="dense",
        seed=2, prefetch=2, drop_remainder=True, return_trace=True)
    cfg = MiniBatchConfig(k=K, chunk_size=512, epochs=2)
    meter = IngestMeter()
    res, tr = aa_kmeans_minibatch_streamed(
        x, torch.from_numpy(x_val), torch.from_numpy(c0), cfg,
        backend="dense", seed=2, prefetch=2, drop_remainder=True,
        meter=meter, return_trace=True, device="cpu")
    n_chunks = x.shape[0] // 512
    assert res.n_steps == int(jres.n_steps) == 2 * n_chunks
    assert meter.chunks == 2 * n_chunks
    assert meter.bytes == 2 * n_chunks * 512 * D * 4
    np.testing.assert_array_equal(tr.accepted.numpy(),
                                  np.asarray(jtr.accepted))
    assert int(res.n_accepted) == int(jres.n_accepted)
    np.testing.assert_allclose(res.centroids.numpy(),
                               np.asarray(jres.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(res.energy), float(jres.energy),
                               rtol=1e-5)


@pytest.mark.parametrize("sort_chunks", [False, True])
def test_streamed_driver_prefetch_depth_and_iterator_source(problem,
                                                            sort_chunks):
    """prefetch 1 and 2 give the same bits; an iterator of the same host
    chunks gives the array source's bits (the caller owns the order)."""
    x, x_val, c0 = problem
    cfg = MiniBatchConfig(k=K, chunk_size=500, epochs=2)
    xv, c = torch.from_numpy(x_val), torch.from_numpy(c0)
    runs = [aa_kmeans_minibatch_streamed(
        x, xv, c, cfg, backend="fused", seed=6, prefetch=p,
        sort_chunks=sort_chunks, device="cpu") for p in (1, 2)]
    it = aa_kmeans_minibatch_streamed(
        host_chunk_stream(x, 500, epochs=2, seed=6), xv, c, cfg,
        backend="fused", sort_chunks=sort_chunks, device="cpu")
    for other in (runs[1], it):
        assert torch.equal(runs[0].centroids, other.centroids)
        assert torch.equal(runs[0].energy, other.energy)
        assert runs[0].n_steps == other.n_steps == 2 * -(-x.shape[0] // 500)


def test_streamed_driver_narrows_float64_operands(problem):
    """float64 x_val and c0 narrow to float32, as the chunks do, so the
    run equals the float32 one bit for bit."""
    x, x_val, c0 = problem
    cfg = MiniBatchConfig(k=K, chunk_size=512, epochs=1)
    f32, f64 = (aa_kmeans_minibatch_streamed(
        x, xv, c, cfg, backend="fused", seed=4, drop_remainder=True,
        device="cpu")
        for xv, c in ((torch.from_numpy(x_val), torch.from_numpy(c0)),
                      (x_val.astype(np.float64), c0.astype(np.float64))))
    assert f64.centroids.dtype == torch.float32
    assert torch.equal(f32.centroids, f64.centroids)
    assert torch.equal(f32.energy, f64.energy)


# -- the benchmark -------------------------------------------------------------

def test_streaming_sweep_smoke(tmp_path):
    """The sweep's protocol end to end at a tiny size on the CPU (its
    numbers are the CPU's and say nothing of the card)."""
    from benchmarks_torch import streaming_sweep
    out = tmp_path / "stream.json"
    summary = streaming_sweep.run(datasets=["Birch"], scale=0.05,
                                  device="cpu", k=5, chunk=512, val=128,
                                  max_epochs=4, verbose=False)
    case = summary["cases"][0]
    assert case["dataset"] == "Birch" and case["full"]["n_iter"] > 0
    for arm in ("minibatch-aa", "minibatch-lloyd"):
        assert case[arm]["samples"] > 0 and np.isfinite(case[arm]["energy"])
    ingest = streaming_sweep.ingest_demo(name="Birch", scale=0.05, k=5,
                                         chunk=256, val=128, epochs=1,
                                         device="cpu", verbose=False)
    assert ingest["equal"] and [a["prefetch"] for a in ingest["arms"]] == \
        [1, 2, 2, 1]
    assert all(a["chunks"] == a["steps"] == ingest["steps"] > 0
               for a in ingest["arms"])
    streaming_sweep.write(out, summary, ingest, device=torch.device("cpu"),
                          complete=True, scale=0.05)
    assert '"benchmark": "streaming_sweep"' in out.read_text()
