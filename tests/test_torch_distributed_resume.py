"""Snapshots and elastic resume of the port's distributed solve
(``make_distributed_kmeans(checkpoint_every=, checkpoint_dir=)``,
``restore_distributed_loop_state``) against itself and across with the
JAX package.

Ranks are spawned Gloo processes on a "cpu" mesh
(``tests/torch_dist_ranks.py``).  A two-rank solve writes a run
directory (only the mesh's first rank writes); it is resumed at the same
world size, where it must equal the uninterrupted run bit for bit, and
at one and four ranks (a (2, 2) mesh over ("pod", "data")), where the
reduction order differs and the energy must agree within 1e-4, as the
reference's tests/test_persistence.py:523-560 asks.  A port snapshot
restores in the reference's ``restore_distributed_loop_state`` on a
one-device mesh with every leaf equal, and a snapshot written by the
reference's single-device ``aa_kmeans`` resumes in the port at two ranks
on the reference's trajectory (labels equal, energy 1e-5, iterations
within 2).  Inputs are numpy from a seed, ``c0`` from the reference's
K-Means++.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.distributed as jdist
from repro.core.backends import get_backend as jget_backend
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.data.synthetic import make_blobs
from repro_torch.core import serialize
from repro_torch.runtime.writer import read_manifest
from torch_dist_ranks import run_ranks

torch.set_num_threads(2)

K, DIM, N, MAX_ITER, EVERY = 8, 6, 2000, 100, 3
ENGINES = ["fused", "hamerly"]


@pytest.fixture(scope="module")
def inputs():
    x = make_blobs(N, DIM, K, seed=3, spread=3.0).astype(np.float32)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(1), jnp.asarray(x), K))
    return dict(x=x, c0=c0)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tmp_path_factory.mktemp("resume")


@pytest.fixture(scope="module")
def written(inputs, base):
    """Per engine: the two ranks' outputs of the ``write`` mode and the
    run directory."""
    out = {}
    for engine in ENGINES:
        run = f"run_{engine}"
        out[engine] = (run_ranks("resume", 2, inputs, base, mode="write",
                                 run_dir=run, backend=engine, every=EVERY,
                                 max_iter=MAX_ITER), base / run)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_only_the_first_rank_writes(engine, written):
    ranks, run = written[engine]
    assert [r["writes"] for r in ranks] == [True, False]
    n_iter = int(ranks[0]["segmented"][3])
    files = sorted(p.name for p in run.glob("it_*.npz"))
    # the last boundary is the final t: n_iter counts one more unless
    # the solve converged (kmeans._result_from_state)
    t_end = n_iter if bool(ranks[0]["segmented"][5]) else n_iter - 1
    assert files == [f"it_{t:08d}.npz" for t in
                     list(range(EVERY, t_end, EVERY)) + [t_end]]
    steps = [e["step"] for e in read_manifest(run)["snapshots"]]
    assert steps == sorted(set(steps))


@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_is_mesh_free(engine, written):
    """The snapshot holds the global state, and its meta the mesh's
    shape and the data axes, as the reference's :258-261 writes them."""
    ranks, run = written[engine]
    meta, by_path = serialize.load(run / f"it_{EVERY:08d}.npz",
                                   expect_kind=serialize.KIND_LOOP)
    assert meta["mesh"] == {"data": 2} and meta["data_axes"] == ["data"]
    assert meta["backend"].endswith("@data")
    assert tuple(by_path["labels"].shape) == (N,)
    for r, rank in enumerate(ranks):
        assert rank["meta"]["t"] == EVERY
        assert torch.equal(rank["restored_labels"],
                           by_path["labels"][r * N // 2:(r + 1) * N // 2])


@pytest.mark.parametrize("engine", ENGINES)
def test_same_world_resume_is_bitwise(engine, written):
    """Resumed at two ranks from the first snapshot: the uninterrupted
    segmented run bit for bit, which is the unsegmented run's."""
    ranks, _ = written[engine]
    for rank in ranks:
        for a, b, c in zip(rank["resumed"], rank["segmented"],
                           rank["whole"]):
            assert torch.equal(a, b) and torch.equal(b, c)
    for a, b in zip(ranks[0]["segmented"], ranks[1]["segmented"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world,opts", [
    (1, {}),
    (4, dict(shape=(2, 2), names=("pod", "data"), axes=("pod", "data")))],
    ids=["W1", "W4-pod-data"])
@pytest.mark.parametrize("engine", ENGINES)
def test_resume_at_another_world_size(engine, world, opts, inputs, base,
                                      written):
    ranks, run = written[engine]
    got = run_ranks("resume", world, inputs, base, mode="from",
                    path=str(run / f"it_{EVERY:08d}.npz"), backend=engine,
                    max_iter=MAX_ITER, **opts)
    want = ranks[0]["segmented"]
    for r in got:
        res = r["resumed"]
        assert float(res[2]) == pytest.approx(float(want[2]), rel=1e-4)
        assert float((res[1] == want[1]).float().mean()) > 0.999
        for a, b in zip(res, got[0]["resumed"]):
            assert torch.equal(a, b)


def test_port_snapshot_restores_in_the_reference(inputs, written):
    """A two-rank port snapshot through the reference's
    restore_distributed_loop_state on a one-device mesh: every leaf of
    the restored state equals the artifact's."""
    _, run = written["fused"]
    path = run / f"it_{EVERY:08d}.npz"
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    cfg = JKMeansConfig(k=K, max_iter=MAX_ITER)
    state, meta = jdist.restore_distributed_loop_state(
        path, jnp.asarray(inputs["x"]), jnp.asarray(inputs["c0"]), cfg,
        jget_backend("fused"), mesh, ("data",))
    assert meta["mesh"] == {"data": 2}
    _, by_path = serialize.load(path)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    assert len(leaves) == len(by_path)
    for keypath, leaf in leaves:
        name = "/".join(str(getattr(k, "name", getattr(k, "idx", k)))
                        for k in keypath)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      by_path[name].numpy())


def test_reference_snapshot_resumes_at_two_ranks(inputs, base, tmp_path):
    """The reference's single-device segmented dense solve writes a run
    directory; the port resumes its first snapshot at two ranks and ends
    on the reference's uninterrupted trajectory."""
    x, c0 = jnp.asarray(inputs["x"]), jnp.asarray(inputs["c0"])
    cfg = JKMeansConfig(k=K, max_iter=MAX_ITER)
    want = jaa_kmeans(x, c0, cfg, backend="dense")
    jaa_kmeans(x, c0, cfg, backend="dense", checkpoint_every=EVERY,
               checkpoint_dir=tmp_path / "ref", sync_writes=True)
    got = run_ranks("resume", 2, inputs, base, mode="from",
                    path=str(tmp_path / "ref" / f"it_{EVERY:08d}.npz"),
                    backend="dense", max_iter=MAX_ITER)
    res = got[0]["resumed"]
    assert np.array_equal(res[1].numpy(), np.asarray(want.labels))
    assert float(res[2]) == pytest.approx(float(want.energy), rel=1e-5)
    assert abs(int(res[3]) - int(want.n_iter)) <= 2
    for a, b in zip(res, got[1]["resumed"]):
        assert torch.equal(a, b)
