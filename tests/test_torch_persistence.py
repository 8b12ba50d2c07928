"""The port's artifact format and estimator persistence against the JAX
package's: ``core/_msgpack.py`` (the port's own MessagePack codec)
against the msgpack package, ``core/serialize.py`` against
``repro.core.serialize``, ``AAKMeans`` / ``MiniBatchAAKMeans``
``save`` / ``load`` and ``checkpoint.load_estimator`` across the two
packages, both ways.

Inputs are numpy from a seed.  The port runs on the CPU (its kernel
engines run their plain versions); the reference runs as its own tests
run it on the CPU.

Tolerances: codec bytes and decoded objects exact (floats by their
bits); artifact leaves, centroids, scalars and predict labels exact
across the packages; transform's squared distances within 1e-6 of
|x|^2 + |c|^2 (both packages expand |x|^2 - 2x.c + |c|^2 in f32 and
round differently, so a small distance may differ far more than 1e-6 of
itself; a loaded model's transform in the package that saved it is
bit-equal to the saved model's); after one more
``partial_fit`` on each side, running sums and counts within 1e-5
relative (XLA may contract the decayed update ``decay * S + s`` into an
FMA where eager torch rounds twice) and labels exact.  The port against
itself (a saved, loaded and continued stream against the uninterrupted
one) is bit for bit.
"""

import math
import struct
from typing import NamedTuple

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.core import serialize as jserialize
from repro.core.api import AAKMeans as JAAKMeans
from repro.core.api import MiniBatchAAKMeans as JMiniBatchAAKMeans
from repro.core.backends import Precision as JPrecision
from repro.core.backends import blocked_backend as jblocked_backend
from repro.core.backends import dense_backend as jdense_backend
from repro.data.synthetic import make_blobs
from repro_torch.checkpoint import load_estimator, save_estimator
from repro_torch.core import AAKMeans, MiniBatchAAKMeans, get_backend
from repro_torch.core import _msgpack
from repro_torch.core import serialize
from repro_torch.interop import estimator_from_arrays

torch.set_num_threads(2)

K, D = 5, 4
CHUNK = 128


def _meta_blob(path) -> bytes:
    with np.load(path, allow_pickle=False) as z:
        return z["__meta__"].tobytes()


def _float_bits(v) -> bytes:
    return struct.pack(">d", v)


def _same(a, b) -> bool:
    """Equal objects, floats by their bits (nan equals nan)."""
    if isinstance(a, float) or isinstance(b, float):
        return type(a) is type(b) and _float_bits(a) == _float_bits(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _bits(a) -> np.ndarray:
    """An array's bits, for exact comparison of float arrays."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


# -- the codec -----------------------------------------------------------------

_INTS = (0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
         -2**63)
# non-ASCII text of exactly n UTF-8 bytes
_TEXT = {n: "é" * (n // 2) + "a" * (n % 2)
         for n in (0, 31, 32, 255, 256, 65535, 65536)}
_CASES = (
    [pytest.param(v, id=f"int{v}") for v in _INTS]
    + [pytest.param(v, id=f"float{v!r}")
       for v in (0.0, -0.0, 1e-12, math.inf, math.nan)]
    + [pytest.param(t, id=f"str{n}") for n, t in _TEXT.items()]
    + [pytest.param(list(range(n)), id=f"list{n}")
       for n in (0, 15, 16, 65535, 65536)]
    + [pytest.param({f"k{i}": i for i in range(n)}, id=f"map{n}")
       for n in (0, 15, 16, 65535, 65536)]
    + [pytest.param(None, id="nil"), pytest.param(True, id="true"),
       pytest.param(False, id="false"),
       pytest.param((1, (2.5, "x"), [None, {"a": (True,)}]), id="tuples"),
       pytest.param({"z": {"y": [1, {"x": [[], {}]}]}, "a": -7}, id="nested")])


@pytest.mark.parametrize("obj", _CASES)
def test_codec_matches_msgpack(obj):
    data = msgpack.packb(obj)
    assert _msgpack.packb(obj) == data
    assert _same(_msgpack.unpackb(data), msgpack.unpackb(data))


def test_codec_reads_float32():
    data = msgpack.packb(1.1, use_single_float=True)
    assert data[0] == 0xca
    assert _same(_msgpack.unpackb(data), msgpack.unpackb(data))


@pytest.mark.parametrize("obj,exc", [
    pytest.param(np.int64(3), TypeError, id="numpy-int"),
    pytest.param(np.float32(1.5), TypeError, id="numpy-float32"),
    pytest.param(np.float64(1.5), TypeError, id="numpy-float64"),
    pytest.param(np.bool_(True), TypeError, id="numpy-bool"),
    pytest.param(b"raw", TypeError, id="bytes"),
    pytest.param({1: "a"}, TypeError, id="int-key"),
    pytest.param(object(), TypeError, id="object"),
    pytest.param(2**64, OverflowError, id="int-too-large"),
    pytest.param(-2**63 - 1, OverflowError, id="int-too-small"),
])
def test_codec_refuses_what_it_cannot_write(obj, exc):
    with pytest.raises(exc):
        _msgpack.packb(obj)


@pytest.mark.parametrize("data,match,msgpack_refuses", [
    pytest.param(msgpack.packb(b"raw"), "bin", False, id="bin"),
    pytest.param(msgpack.packb(msgpack.ExtType(1, b"x")), "ext", False,
                 id="ext"),
    pytest.param(msgpack.packb({1: "a"}), "not a str", True, id="int-key"),
    pytest.param(msgpack.packb({"a": [1, 2, 3]})[:-1], "truncated", True,
                 id="truncated"),
    pytest.param(msgpack.packb("abc")[:2], "truncated", True,
                 id="truncated-str"),
    pytest.param(b"", "truncated", True, id="empty"),
    pytest.param(msgpack.packb(1) + b"\x00", "trailing", True,
                 id="trailing"),
])
def test_codec_refuses_what_it_cannot_read(data, match, msgpack_refuses):
    """Refused with ValueError, as msgpack refuses the same input, or (bin
    and ext, which msgpack reads) because the meta block never holds it."""
    with pytest.raises(ValueError, match=match):
        _msgpack.unpackb(data)
    if msgpack_refuses:
        with pytest.raises(ValueError):
            msgpack.unpackb(data)


# -- reference artifacts -----------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return make_blobs(1200, D, K, seed=3, spread=3.0)


@pytest.fixture(scope="module")
def ref_artifacts(tmp_path_factory, data):
    """Artifacts the reference wrote: an AAKMeans fitted on "dense", one
    on a blocked128 Backend instance, and a mid-stream MiniBatchAAKMeans
    whose n_accepted_ is None."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    jm = JAAKMeans(n_clusters=K, max_iter=40, seed=0).fit(data)
    out["aa-dense"] = jm.save(d / "aa_dense")
    jb = JAAKMeans(n_clusters=K, max_iter=40, seed=0,
                   backend=jblocked_backend(128)).fit(data)
    out["aa-blocked128"] = jb.save(d / "aa_blocked")
    mb = JMiniBatchAAKMeans(n_clusters=K, chunk_size=CHUNK, seed=0)
    for i in range(0, 4 * CHUNK, CHUNK):
        mb.partial_fit(data[i:i + CHUNK])
    mb.n_accepted_ = None
    out["mb-midstream"] = mb.save(d / "mb_mid")
    return out


@pytest.mark.parametrize("name", ["aa-dense", "aa-blocked128",
                                  "mb-midstream"])
def test_codec_on_reference_metas(ref_artifacts, name):
    blob = _meta_blob(ref_artifacts[name])
    meta = msgpack.unpackb(blob)
    assert _same(_msgpack.unpackb(blob), meta)
    assert _msgpack.packb(meta) == blob
    if name == "mb-midstream":
        assert meta["scalars"]["n_accepted_"] is None


# -- flatten_with_paths ----------------------------------------------------------

class Pair(NamedTuple):
    second: object
    first: object


def _mirrored_tree(leaf):
    """A tree with unsorted dict keys, NamedTuples (fields not in sorted
    order), tuples, lists and None subtrees; ``leaf(i)`` makes leaf i."""
    return {"zeta": (leaf(0), None, [leaf(1), (leaf(2),)]),
            "alpha": Pair(second={"b": leaf(3), "a": None, "c": leaf(4)},
                          first=leaf(5)),
            "mid": [None, Pair(leaf(6), ()), {}],
            "10": leaf(7), "9": leaf(8)}


def test_flatten_with_paths_matches_reference():
    jpaths, jleaves, _ = jserialize.flatten_with_paths(
        _mirrored_tree(lambda i: jnp.full((2,), i, jnp.float32)))
    paths, leaves, treedef = serialize.flatten_with_paths(
        _mirrored_tree(lambda i: torch.full((2,), i, dtype=torch.float32)))
    assert paths == jpaths
    assert [float(a[0]) for a in leaves] == [float(a[0]) for a in jleaves]
    again = serialize.unflatten(treedef, [a + 1 for a in leaves])
    assert serialize.flatten_with_paths(again)[0] == paths
    assert [float(a[0]) for a in serialize.flatten_with_paths(again)[1]] == \
        [float(a[0]) + 1 for a in leaves]


# -- round trip and refusals (mirroring tests/test_persistence.py) --------------

def test_serialize_roundtrip_bit_exact(tmp_path):
    tree = {"c": torch.arange(12, dtype=torch.float32).reshape(3, 4) * np.pi,
            "w": {"m": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
                  "t": torch.tensor(7, dtype=torch.int32)},
            "flag": torch.tensor(True), "key": np.arange(2, dtype=np.uint32)}
    p = serialize.save(tmp_path / "s", tree, kind="unit", extra={"t": 3})
    assert p.suffix == ".npz" and p.exists()
    like = {"c": torch.empty((3, 4), device="meta"),
            "w": {"m": torch.empty((5,), dtype=torch.bfloat16,
                                   device="meta"),
                  "t": torch.empty((), dtype=torch.int32, device="meta")},
            "flag": torch.empty((), dtype=torch.bool, device="meta"),
            "key": np.zeros(2, np.uint32)}
    out, meta = serialize.restore(p, like, expect_kind="unit", device="cpu")
    assert meta["t"] == 3 and meta["schema"] == serialize.SCHEMA_VERSION
    for a, b in zip(serialize.flatten_with_paths(tree)[1],
                    serialize.flatten_with_paths(out)[1]):
        a = torch.as_tensor(a)
        assert b.dtype == a.dtype and b.device.type == "cpu"
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16
                           else b)
    # the reference reads the port's artifact leaf for leaf
    jmeta, jby_path = jserialize.load(p, expect_kind="unit")
    assert jmeta["leaves"] == meta["leaves"]
    assert str(jby_path["w/m"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jby_path["w/m"], np.float32),
                                  np.full(5, 1.5, np.float32))


def test_serialize_refuses_newer_schema_and_wrong_kind(tmp_path, monkeypatch):
    p = serialize.save(tmp_path / "s", {"a": torch.zeros((2,))}, kind="unit")
    with pytest.raises(ValueError, match="expected 'other'"):
        serialize.load(p, expect_kind="other")
    monkeypatch.setattr(serialize, "SCHEMA_VERSION", 0)
    with pytest.raises(ValueError, match="newer"):
        serialize.load(p)


def test_restore_shape_mismatch_is_loud(tmp_path):
    p = serialize.save(tmp_path / "s", {"a": torch.zeros((4, 2))},
                       kind="unit")
    with pytest.raises(ValueError, match="shape mismatch"):
        serialize.restore(p, {"a": torch.empty((3, 2), device="meta")},
                          device="cpu")
    with pytest.raises(ValueError, match="missing leaves"):
        serialize.restore(p, {"b": torch.empty((4, 2), device="meta")},
                          device="cpu")


def test_serialize_migration_chain(tmp_path, monkeypatch):
    """An older schema is upgraded through registered migrations; a gap
    fails loudly instead of guessing."""
    tree_old = {"c": torch.arange(6, dtype=torch.float32).reshape(3, 2),
                "e": torch.tensor(4.5)}
    p = serialize.save(tmp_path / "s", tree_old, kind=serialize.KIND_LOOP,
                       extra={"t": 5})
    monkeypatch.setattr(serialize, "SCHEMA_VERSION",
                        serialize.SCHEMA_VERSION + 1)
    with pytest.raises(ValueError, match="no migration is registered"):
        serialize.load(p)

    def mig(meta, by_path):      # the bump renamed 'e' -> 'energy'
        by_path["energy"] = by_path.pop("e")
        for leaf in meta["leaves"]:
            if leaf["path"] == "e":
                leaf["path"] = "energy"
        return meta, by_path

    serialize.register_migration(serialize.KIND_LOOP,
                                 serialize.SCHEMA_VERSION - 1, mig)
    try:
        like = {"c": torch.empty((3, 2), device="meta"),
                "energy": torch.empty((), device="meta")}
        out, meta = serialize.restore(p, like,
                                      expect_kind=serialize.KIND_LOOP,
                                      device="cpu")
        assert meta["schema"] == serialize.SCHEMA_VERSION and meta["t"] == 5
        assert torch.equal(out["c"], tree_old["c"])
        assert float(out["energy"]) == 4.5
    finally:
        serialize.unregister_migration(serialize.KIND_LOOP,
                                       serialize.SCHEMA_VERSION - 1)


def test_reference_bf16_leaf_loads_bit_equal(tmp_path):
    vals = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    p = jserialize.save(tmp_path / "bf", {"w": vals}, kind="unit")
    _, by_path = serialize.load(p)
    assert by_path["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(by_path["w"].view(torch.int16).numpy(),
                                  np.asarray(vals).view(np.int16))


def test_unsupported_leaf_dtype_is_refused(tmp_path):
    p = jserialize.save(tmp_path / "f8",
                        {"w": jnp.zeros((3,), jnp.float8_e4m3fn)},
                        kind="unit")
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        serialize.load(p)


# -- AAKMeans across the packages ------------------------------------------------

def _assert_transform_close(got, want, x, c):
    """Squared distances within 1e-6 of the terms the expansion
    |x|^2 - 2x.c + |c|^2 cancels: both packages expand in f32, and their
    rounding differs in the last bits of those terms."""
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    scale = (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
    gap = np.abs(np.asarray(got, np.float64) ** 2
                 - np.asarray(want, np.float64) ** 2)
    assert np.all(gap <= 1e-6 * scale), float((gap / scale).max())


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_reference_aakmeans_loads_in_the_port(tmp_path, data, backend):
    jm = JAAKMeans(n_clusters=K, max_iter=40, seed=0,
                   backend=backend).fit(data)
    p = jm.save(tmp_path / "model")
    for tm in (AAKMeans.load(p, device="cpu"),
               load_estimator(p, device="cpu")):
        assert type(tm) is AAKMeans and tm.backend == backend
        assert tm.centroids_.device.type == "cpu"
        np.testing.assert_array_equal(_bits(tm.centroids_),
                                      _bits(jm.centroids_))
        np.testing.assert_array_equal(tm.labels_.numpy(),
                                      np.asarray(jm.labels_))
        assert (tm.energy_, tm.n_iter_, tm.n_accepted_) == \
            (jm.energy_, jm.n_iter_, jm.n_accepted_)
        np.testing.assert_array_equal(tm.predict(data), jm.predict(data))
        _assert_transform_close(tm.transform(data), jm.transform(data),
                                data, jm.centroids_)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_port_aakmeans_loads_in_the_reference(tmp_path, data, backend):
    tm = AAKMeans(n_clusters=K, max_iter=40, seed=0, backend=backend,
                  device="cpu").fit(data)
    p = save_estimator(tm, tmp_path / "model")
    jm = JAAKMeans.load(p)
    assert jm.backend == backend and jm.n_clusters == K
    np.testing.assert_array_equal(_bits(jm.centroids_),
                                  _bits(tm.centroids_))
    np.testing.assert_array_equal(np.asarray(jm.labels_), tm.labels_.numpy())
    assert (jm.energy_, jm.n_iter_, jm.n_accepted_) == \
        (tm.energy_, tm.n_iter_, tm.n_accepted_)
    np.testing.assert_array_equal(jm.predict(data), tm.predict(data))
    _assert_transform_close(jm.transform(data), tm.transform(data), data,
                            jm.centroids_)
    # inside one package a loaded model serves exactly as the saved one
    back = AAKMeans.load(p, device="cpu")
    np.testing.assert_array_equal(_bits(back.transform(data)),
                                  _bits(tm.transform(data)))


def test_backend_instances_round_trip(tmp_path, ref_artifacts, data):
    """A blocked128 instance is rebuilt in both directions; a precision
    policy of float32 is kept."""
    tm = AAKMeans.load(ref_artifacts["aa-blocked128"], device="cpu")
    assert tm.backend.name == "blocked128"
    jb = JAAKMeans.load(ref_artifacts["aa-blocked128"])
    np.testing.assert_array_equal(tm.predict(data), jb.predict(data))
    tb = AAKMeans(n_clusters=K, max_iter=40, device="cpu",
                  backend=get_backend("blocked", block_n=64)).fit(data)
    assert JAAKMeans.load(tb.save(tmp_path / "b")).backend.name == \
        "blocked64"
    assert AAKMeans.load(tmp_path / "b.npz", device="cpu").backend is \
        tb.backend
    model = estimator_from_arrays(
        {"n_clusters": K, "backend": {"name": "dense", "compute": "float32"}},
        {"centroids_": np.zeros((K, D), np.float32)}, device="cpu")
    assert model.backend.precision.compute == torch.float32


@pytest.mark.parametrize("backend,exc,match", [
    pytest.param(jdense_backend(JPrecision(compute=jnp.bfloat16)),
                 None, None, id="bf16-compute"),
    pytest.param(jdense_backend(JPrecision(accum=jnp.bfloat16)),
                 None, None, id="bf16-accum"),
    pytest.param(jdense_backend(JPrecision(compute=jnp.float16)),
                 NotImplementedError, "float32 and bfloat16",
                 id="f16-compute"),
])
def test_unported_precision_is_refused(tmp_path, data, backend, exc, match):
    """A reference artifact with a bf16 policy loads with that policy and
    predicts as the reference does, and the port's save of it loads back
    in the reference with the same policy; float16 is refused."""
    jm = JAAKMeans(n_clusters=K, max_iter=5, backend=backend).fit(data)
    p = jm.save(tmp_path / "model")
    if exc is not None:
        with pytest.raises(exc, match=match):
            AAKMeans.load(p, device="cpu")
        return
    model = AAKMeans.load(p, device="cpu")
    want = backend.precision
    got = model.backend.precision
    assert (got.compute, got.accum) == tuple(
        None if dt is None else torch.bfloat16
        for dt in (want.compute, want.accum))
    np.testing.assert_array_equal(model.predict(data),
                                  np.asarray(jm.predict(data)))
    back = JAAKMeans.load(model.save(tmp_path / "port"))
    assert (back.backend.precision.compute, back.backend.precision.accum) \
        == (want.compute, want.accum)
    np.testing.assert_array_equal(np.asarray(back.predict(data)),
                                  np.asarray(jm.predict(data)))


@pytest.mark.parametrize("name", ["fused+count", "elkan+reorder",
                                  "nonexistent"])
def test_unregistered_backend_name_is_refused(tmp_path, data, name):
    jm = JAAKMeans(n_clusters=K, max_iter=5).fit(data)
    meta, by_path = jserialize.load(jm.save(tmp_path / "model"))
    meta["params"]["backend"] = {"name": name}
    arrays = {n: by_path[f"arrays/{n}"] for n in meta["has"]}
    p = jserialize.save(tmp_path / "renamed", {"arrays": arrays},
                        kind=meta["kind"],
                        extra={key: meta[key] for key in
                               ("params", "scalars", "has", "has_stream")})
    with pytest.raises(ValueError, match="cannot be rebuilt"):
        AAKMeans.load(p, device="cpu")
    meta["params"]["backend"] = name
    p = jserialize.save(tmp_path / "named", {"arrays": arrays},
                        kind=meta["kind"],
                        extra={key: meta[key] for key in
                               ("params", "scalars", "has", "has_stream")})
    with pytest.raises(ValueError, match="cannot be rebuilt"):
        AAKMeans.load(p, device="cpu")


@pytest.mark.parametrize("what", ["serving", "hierarchy"])
def test_unported_arrays_are_refused(tmp_path, data, what):
    """The hierarchy's arrays are ported: they load, beside the serving
    index ("serving") or alone.  An array the port's estimator has no
    field for is refused, and the refusal names it alone."""
    jm = JAAKMeans(n_clusters=K, max_iter=40, seed=0).fit(data)
    if what == "serving":
        jm.build_serving_index()
    jm.hier_routers_ = jnp.zeros((2, D), jnp.float32)
    jm.hier_offsets_ = jnp.asarray([0, 2, K], jnp.int32)
    p = jm.save(tmp_path / "model")
    for load in (lambda: AAKMeans.load(p, device="cpu"),
                 lambda: load_estimator(p, device="cpu")):
        tm = load()
        assert np.array_equal(tm.hier_offsets_.numpy(), [0, 2, K])
        assert tm.hier_routers_.shape == (2, D)
        assert (tm.closure_routers_ is not None) == (what == "serving")
    meta, by_path = jserialize.load(p)
    arrays = {n: by_path[f"arrays/{n}"] for n in meta["has"]}
    arrays["mesh_shards_"] = np.zeros(2, np.int32)
    p = jserialize.save(tmp_path / "extra", {"arrays": arrays},
                        kind=meta["kind"],
                        extra={**{key: meta[key] for key in
                                  ("params", "scalars", "has_stream")},
                               "has": sorted(arrays)})
    for load in (lambda: AAKMeans.load(p, device="cpu"),
                 lambda: load_estimator(p, device="cpu")):
        with pytest.raises(ValueError, match="mesh_shards_") as err:
            load()
        assert "hier_" not in str(err.value)
        assert "closure_" not in str(err.value)


def test_load_estimator_picks_the_class(tmp_path, ref_artifacts):
    assert type(load_estimator(ref_artifacts["aa-dense"],
                               device="cpu")) is AAKMeans
    assert type(load_estimator(ref_artifacts["mb-midstream"],
                               device="cpu")) is MiniBatchAAKMeans
    p = serialize.save(tmp_path / "junk", {"a": torch.zeros(2)}, kind="unit")
    with pytest.raises(ValueError, match="not an estimator artifact"):
        load_estimator(p, device="cpu")
    with pytest.raises(ValueError, match="expected 'estimator/aa_kmeans'"):
        AAKMeans.load(ref_artifacts["mb-midstream"], device="cpu")


# -- MiniBatchAAKMeans mid-stream across the packages -------------------------------

def _jstate_leaves(jm):
    """The reference model's stream as {path: numpy leaf}."""
    tree = {"state": jm._state, "x_val": jm._x_val}
    paths, leaves, _ = jserialize.flatten_with_paths(tree)
    return dict(zip(paths, (np.asarray(a) for a in leaves)))


def _tstate_leaves(tm):
    """The port model's stream, in the reference's layout."""
    from repro_torch.core.minibatch import reference_layout
    tree = {"state": reference_layout(tm._state), "x_val": tm._x_val}
    paths, leaves, _ = serialize.flatten_with_paths(tree)
    return dict(zip(paths, (a.numpy() for a in leaves)))


def _step_and_compare(jm, tm, chunk, data):
    """One more partial_fit on each side: running stats at 1e-5, the
    step count and predict's labels exact."""
    jm.partial_fit(chunk)
    tm.partial_fit(chunk)
    assert tm.n_steps_ == int(jm.n_steps_)
    for f in ("sums", "counts"):
        np.testing.assert_allclose(getattr(tm._state, f).numpy(),
                                   np.asarray(getattr(jm._state, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(tm.centroids_.numpy(),
                               np.asarray(jm.centroids_), rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(data), jm.predict(data))


def test_reference_midstream_loads_in_the_port(tmp_path, data):
    jm = JMiniBatchAAKMeans(n_clusters=K, chunk_size=CHUNK, seed=0)
    for i in range(0, 4 * CHUNK, CHUNK):
        jm.partial_fit(data[i:i + CHUNK])
    p = jm.save(tmp_path / "mid")
    tm = MiniBatchAAKMeans.load(p, device="cpu")
    assert tm.n_steps_ == 4 and tm._state.t == 4
    assert tm._state.aa.dF.shape[0] == 1
    want, got = _jstate_leaves(jm), _tstate_leaves(tm)
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]),
                                      err_msg=path)
    assert tm.energy_ == float(jm.energy_)
    assert tm.n_accepted_ == int(jm.n_accepted_)
    _step_and_compare(jm, tm, data[4 * CHUNK:5 * CHUNK], data)


def test_port_midstream_loads_in_the_reference(tmp_path, data):
    tm = MiniBatchAAKMeans(n_clusters=K, chunk_size=CHUNK, seed=0,
                           device="cpu")
    for i in range(0, 4 * CHUNK, CHUNK):
        tm.partial_fit(data[i:i + CHUNK])
    p = tm.save(tmp_path / "mid")
    jm = JMiniBatchAAKMeans.load(p)
    assert int(jm.n_steps_) == 4 and jm.energy_ == float(tm.energy_)
    want, got = _tstate_leaves(tm), _jstate_leaves(jm)
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]),
                                      err_msg=path)
    _step_and_compare(jm, tm, data[4 * CHUNK:5 * CHUNK], data)


def test_finished_minibatch_round_trips_both_ways(tmp_path, data):
    """A fitted (not mid-stream) model: labels_ stays a host array."""
    tm = MiniBatchAAKMeans(n_clusters=K, chunk_size=CHUNK, epochs=2,
                           val_size=256, seed=0, device="cpu").fit(data)
    p = tm.save(tmp_path / "done")
    back = MiniBatchAAKMeans.load(p, device="cpu")
    assert back._state is None and isinstance(back.labels_, np.ndarray)
    np.testing.assert_array_equal(back.labels_, tm.labels_)
    assert (back.energy_, back.n_steps_, back.n_accepted_) == \
        (tm.energy_, tm.n_steps_, tm.n_accepted_)
    jm = JMiniBatchAAKMeans.load(p)
    assert jm._state is None
    np.testing.assert_array_equal(jm.predict(data), tm.predict(data))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_port_midstream_resume_is_bit_identical(tmp_path, data, backend):
    """A partial_fit stream saved, loaded in a fresh estimator and fed the
    remaining chunks ends bit for bit where the uninterrupted one does."""
    kw = dict(n_clusters=K, chunk_size=CHUNK, seed=0, backend=backend,
              device="cpu")
    chunks = [data[i:i + CHUNK] for i in range(0, 8 * CHUNK, CHUNK)]
    a = MiniBatchAAKMeans(**kw)
    for ch in chunks[:4]:
        a.partial_fit(ch)
    b = MiniBatchAAKMeans.load(a.save(tmp_path / "mid"), device="cpu")
    assert b.backend == backend and b.device == "cpu"
    for m in (a, b):
        for ch in chunks[4:]:
            m.partial_fit(ch)
        m.finalize()
    assert torch.equal(a.centroids_, b.centroids_)
    assert a.energy_ == b.energy_ and a.n_steps_ == b.n_steps_ == 8
    assert torch.equal(a.n_accepted_, b.n_accepted_)
    for f in ("sums", "counts", "c"):
        assert torch.equal(getattr(a._state, f), getattr(b._state, f))
    for x, y in zip(a._state.aa, b._state.aa):
        assert torch.equal(x, y)
