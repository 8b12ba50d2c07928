"""The port's distribution (``backends.distribute``,
``core/distributed.py``) against the JAX package and against itself:
the wrapped step of every engine, the combinator's refusals, the solve
drivers at one, two and four ranks.

Ranks are spawned Gloo processes on a "cpu" ``DeviceMesh``
(``tests/torch_dist_ranks.py``), each single-threaded, meeting through a
``FileStore`` under the test's temporary directory and killed at a wall
limit; each spawn is shared by the tests of one fixture.  Inputs are
numpy from a seed, ``c0`` from the reference's K-Means++.  The
reference's own distributed solves do not run here (ROADMAP queue C), so
the port is held to the reference's single-device solve and its
one-device ``distribute(dense)``, and to itself.  Tolerances: a
one-rank mesh equals the undistributed port bit for bit; every rank's
replicated results are equal bit for bit; at two and four ranks labels
equal the reference's, stats within rtol 1e-6 (a row's distance within
1e-5: its product is blocked by the row count), energies within 1e-5 and
iteration counts within 2 (the reduction order may flip the accept test
near convergence, DESIGN.md §Distribution); the minibatch driver within
1e-4 of the single-device one, bit for bit on repeat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import backends as JB
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.data.synthetic import make_blobs
from repro_torch.core import distributed as D
from repro_torch.core.backends import backend_names, distribute, get_backend
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans_batched,
                                     aa_kmeans_minibatch, select_best)
from repro_torch.core.locality import reorder_backend
from repro_torch.core.minibatch import MiniBatchConfig
from repro_torch.data.streaming import chunk_dataset
from torch_dist_ranks import run_ranks

torch.set_num_threads(2)

K, DIM = 8, 6
ENGINES = backend_names()


def _t(a):
    return torch.from_numpy(np.array(a))


# -- one step of every engine ------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs():
    x = make_blobs(400, DIM, K, seed=1, spread=2.0).astype(np.float32)
    c = np.asarray(jkmeanspp(jax.random.PRNGKey(0), jnp.asarray(x), K))
    c2 = (c + 0.05 * np.random.default_rng(2).standard_normal(c.shape)
          ).astype(np.float32)
    cs = np.stack([c, x[:K], x[K:2 * K]])
    return dict(x=x, c=c, c2=c2, cs=cs)


@pytest.fixture(scope="module")
def step_runs(step_inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    return {w: run_ranks("steps", w, step_inputs, tmp) for w in (1, 2)}


def _local_steps(name, x, c, c2):
    bk = get_backend(name)
    res, carry = bk.step(x, c, K, bk.init_carry(x, c, K))
    res2, _ = bk.step(x, c2, K, carry)
    return res, res2


@pytest.mark.parametrize("name", ENGINES)
def test_one_rank_step_equals_the_local_step(name, step_inputs, step_runs):
    """distribute(b) on a one-rank mesh gives the local step's bits (in
    the same process), two steps running (the second at other centroids,
    on the first's carry)."""
    got = step_runs[1][0][name]
    assert got["name"] == f"{get_backend(name).name}@data"
    for want, have in zip(step_runs[1][0]["local"][name],
                          (got["step"], got["step2"])):
        for a, b in zip(want, have):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ENGINES)
def test_two_rank_step_matches_the_local_step(name, step_inputs, step_runs):
    """At two ranks: labels equal on every row, the reduced stats and
    energy within 1e-6 and equal bit for bit on both ranks, as are the
    BoundStats a bound engine carries (averaged over the ranks)."""
    x, c, c2 = (_t(step_inputs[key]) for key in ("x", "c", "c2"))
    ranks = step_runs[2]
    for want, key in zip(_local_steps(name, x, c, c2), ("step", "step2")):
        got = [r[name][key] for r in ranks]
        labels = torch.cat([g[0] for g in got])
        assert torch.equal(labels, want.labels)
        # a row's distance comes from a product blocked by the row count
        torch.testing.assert_close(torch.cat([g[1] for g in got]),
                                   want.min_sqdist, rtol=1e-5, atol=1e-5)
        for i in (2, 3, 4):
            torch.testing.assert_close(got[0][i], want[i], rtol=1e-6,
                                       atol=1e-4)
            assert torch.equal(got[0][i], got[1][i])
    stats = [r[name]["stats"] for r in ranks]
    if stats[0] is not None:
        for a, b in zip(*stats):
            assert torch.equal(a, b) and 0.0 <= float(a) <= 1.0


@pytest.mark.parametrize("world", [1, 2])
def test_distribute_dense_matches_the_reference_one_device(
        world, step_inputs, step_runs):
    """The reference's distribute(dense) under a one-device shard_map
    against the port's at one and two ranks: labels equal, sums 1e-6."""
    x, c = jnp.asarray(step_inputs["x"]), jnp.asarray(step_inputs["c"])
    dist = JB.distribute(JB.get_backend("dense"), ("data",))
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def run(xx, cc):
        return dist.step(xx, cc, K, dist.init_carry(xx, cc, K))[0]

    ref = compat.shard_map(run, mesh=mesh, in_specs=(P("data"), P()),
                           out_specs=JB.StepResult(
                               labels=P("data"), min_sqdist=P("data"),
                               sums=P(), counts=P(), energy=P()))(x, c)
    got = [r["dense"]["step"] for r in step_runs[world]]
    assert np.array_equal(torch.cat([g[0] for g in got]).numpy(),
                          np.asarray(ref.labels))
    np.testing.assert_allclose(got[0][2].numpy(), np.asarray(ref.sums),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[0][3].numpy(), np.asarray(ref.counts))
    np.testing.assert_allclose(float(got[0][4]), float(ref.energy),
                               rtol=1e-6)


@pytest.mark.parametrize("slot", ["batched_dense", "batched_blocked"])
def test_batched_step_makes_one_collective(slot, step_inputs, step_runs):
    """R = 3 restarts, natively batched (dense) or through the
    per-restart fallback (blocked), reduce in one collective."""
    x, cs = _t(step_inputs["x"]), _t(step_inputs["cs"])
    bk = get_backend(slot.split("_")[1])
    want, _ = bk.batched_step(x, cs, K, bk.batched_init_carry(x, cs, K))
    for world in (1, 2):
        for r in step_runs[world]:
            res, counts = r[slot]
            assert counts == {"step": 1}
            torch.testing.assert_close(res[2], want.sums, rtol=1e-6,
                                       atol=1e-4)
            assert torch.equal(res[3], want.counts)


def test_energy_op_reduces_once(step_inputs, step_runs):
    """The reference's test_distributed_energy_op_reduces_once at two
    ranks, where a double reduction would show: the wrapped energy of a
    fixed assignment equals the global one."""
    x, c = _t(step_inputs["x"]), _t(step_inputs["c"])
    dense = get_backend("dense")
    want = float(dense.energy(x, c, dense.assign(x, c).labels))
    for r in step_runs[2]:
        assert float(r["energy"]) == pytest.approx(want, rel=1e-5)
        assert r["converged"] is True


@pytest.mark.parametrize("world", [1, 2])
def test_distributed_lloyd_ops(world, step_inputs, step_runs):
    """The legacy distributed_lloyd_ops: G(C) from the reduced stats
    (within 1e-6: the ranks run single-threaded, this process not), the
    energy reduced once, the convergence test and reduce_scalar summed
    over the ranks."""
    from repro_torch.core.lloyd import DENSE_OPS
    x, c = _t(step_inputs["x"]), _t(step_inputs["c"])
    want_c, want_res = DENSE_OPS.g_map(x, c, K)
    want_e = float(DENSE_OPS.energy_fn(x, c, want_res.labels))
    for r in step_runs[world]:
        c_new, e, same, ones = r["lloyd_ops"]
        torch.testing.assert_close(c_new, want_c, rtol=1e-6, atol=1e-5)
        assert float(e) == pytest.approx(want_e, rel=1e-5)
        assert same is True and float(ones) == world


def test_collective_outside_a_mesh_scope_raises(step_inputs, step_runs):
    x, c = _t(step_inputs["x"]), _t(step_inputs["c"])
    bk = distribute(get_backend("dense"), ("data",))
    with pytest.raises(RuntimeError, match="outside a mesh scope"):
        bk.energy(x, c, torch.zeros(x.shape[0], dtype=torch.int32))
    assert "outside a mesh scope" in step_runs[2][1]["raised"]["outside"]


def test_double_wrap_refused_and_prewrapped_accepted():
    """The reference's tests/test_backends.py:245-262: wrapping twice is
    refused; a backend already wrapped over the solver's axes is used as
    it is, one over other axes refused."""
    wrapped = distribute(get_backend("dense"), ("data",))
    assert wrapped.axes == ("data",) and wrapped.name == "dense@data"
    with pytest.raises(ValueError, match="already distributed"):
        distribute(wrapped, ("data",))
    cfg = KMeansConfig(k=K)
    assert D._resolve_distributed(wrapped, cfg, 0, ("data",)) is wrapped
    with pytest.raises(ValueError, match="distributed over"):
        D._resolve_distributed(wrapped, cfg, 0, ("pod", "data"))
    two = distribute(get_backend("fused"), ("pod", "data"))
    assert two.name == "fused@podxdata"


def test_reorder_composition_order(step_inputs, step_runs):
    """reorder_backend(distribute(b)) is refused with the reference's
    message; distribute(reorder_backend(b)) sorts shard-local, and its
    two-rank step gives the local wrapped step's labels."""
    with pytest.raises(ValueError, match="shard-local"):
        reorder_backend(distribute(get_backend("hamerly"), ("data",)))
    assert "shard-local" in \
        step_runs[2][0]["raised"]["reorder_of_distributed"]
    x, c = _t(step_inputs["x"]), _t(step_inputs["c"])
    bk = get_backend("hamerly_reorder")
    want, _ = bk.step(x, c, K, bk.init_carry(x, c, K))
    got = [r["distribute_of_reorder"] for r in step_runs[2]]
    assert got[0][0] == "hamerly+reorder@data"
    assert torch.equal(torch.cat([g[1][0] for g in got]), want.labels)
    torch.testing.assert_close(got[0][1][2], want.sums, rtol=1e-6,
                               atol=1e-4)


# -- the solve drivers -------------------------------------------------------

MESHES = {
    "W1": (1, {}),
    "W2": (2, {}),
    "W4-pod-data": (4, dict(shape=(2, 2), names=("pod", "data"),
                            axes=("pod", "data"))),
    "W4-data-only": (4, dict(shape=(2, 2), names=("pod", "data"),
                             axes=("data",))),
}
MAX_ITER, CHUNK, VAL = 100, 200, 400


@pytest.fixture(scope="module")
def solve_inputs():
    x = make_blobs(2000, DIM, K, seed=3, spread=3.0).astype(np.float32)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(1), jnp.asarray(x), K))
    cs = np.stack([c0, x[:K], x[100:100 + K]])
    return dict(x=x, c0=c0, cs=cs)


@pytest.fixture(scope="module")
def solve_runs(solve_inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solves")
    return {key: run_ranks("solves", w, solve_inputs, tmp, max_iter=MAX_ITER,
                           chunk=CHUNK, val=VAL, **opts)
            for key, (w, opts) in MESHES.items()}


@pytest.fixture(scope="module")
def reference_solve(solve_inputs):
    res = jaa_kmeans(jnp.asarray(solve_inputs["x"]),
                     jnp.asarray(solve_inputs["c0"]),
                     JKMeansConfig(k=K, max_iter=MAX_ITER))
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_distributed_solve_matches_the_reference(mesh, engine, solve_runs,
                                                 reference_solve):
    """make_distributed_kmeans against the reference's single-device
    aa_kmeans from the same c0: labels equal, energy 1e-5, n_iter within
    2; every rank's centroids and scalars equal bit for bit, and the
    labels global on every rank."""
    ranks = solve_runs[mesh]
    got = ranks[0][engine]
    assert np.array_equal(got[1].numpy(), reference_solve.labels)
    assert float(got[2]) == pytest.approx(float(reference_solve.energy),
                                          rel=1e-5)
    assert abs(int(got[3]) - int(reference_solve.n_iter)) <= 2
    np.testing.assert_allclose(got[0].numpy(), reference_solve.centroids,
                               rtol=1e-4, atol=1e-4)
    for r in ranks[1:]:
        for a, b in zip(got, r[engine]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["dense", "fused", "batched",
                                  "minibatch"])
def test_one_rank_solve_is_the_local_solve_bitwise(what, solve_runs):
    """At one rank each driver gives the undistributed driver's bits (in
    the same process): make_distributed_kmeans on dense and fused, the
    batched pick at R = 3, the minibatch driver."""
    run = solve_runs["W1"][0]
    got = {"batched": run["batched"][0],
           "minibatch": run["minibatch"][0][0]}.get(what, run.get(what))
    for a, b in zip(run["local"][what], got):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batched_pick_best_one_collective_per_trip(mesh, solve_inputs,
                                                   solve_runs):
    """make_distributed_kmeans_batched(pick_best=True) at R = 3: one step
    collective per trip (and the init's) for all three restarts, one
    convergence count per trip; the winner the local batched solve's
    labels, its energy within 1e-5."""
    want = select_best(aa_kmeans_batched(
        _t(solve_inputs["x"]), _t(solve_inputs["cs"]),
        KMeansConfig(k=K, max_iter=MAX_ITER), backend="dense"))
    ranks = solve_runs[mesh]
    best, counts = ranks[0]["batched"]
    assert counts["step"] == counts["converged"] + 1
    assert counts["gather"] == 1 and set(counts) == {"step", "converged",
                                                      "gather"}
    assert torch.equal(best[1], want.labels)
    assert float(best[2]) == pytest.approx(float(want.energy), rel=1e-5)
    for r in ranks[1:]:
        for a, b in zip(best, r["batched"][0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_minibatch_driver_matches_single_device(mesh, solve_inputs,
                                                solve_runs):
    """make_distributed_kmeans_minibatch against the port's single-device
    aa_kmeans_minibatch with the same chunk order: energy 1e-4, equal
    on repeat and on every rank, one collective
    per chunk step and one per guard (2 epochs of 8 chunks, then the
    final pick)."""
    x, c0 = _t(solve_inputs["x"]), _t(solve_inputs["c0"])
    cfg = MiniBatchConfig(k=K, chunk_size=CHUNK, epochs=2)
    dc = chunk_dataset(x[VAL:], CHUNK)
    want = aa_kmeans_minibatch(dc.chunks, dc.weights, x[:VAL], c0, cfg,
                               backend="fused",
                               generator=torch.Generator().manual_seed(3),
                               device="cpu")
    ranks = solve_runs[mesh]
    (first, counts), (again, _) = ranks[0]["minibatch"]
    assert counts == {"step": 2 * 2 * 8 + 1}
    assert float(first[1]) == pytest.approx(float(want.energy), rel=1e-4)
    assert first[2] == want.n_steps
    for a, b in zip(first, again):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    for r in ranks[1:]:
        assert torch.equal(first[0], r["minibatch"][0][0][0])


def test_shard_dataset_pads_with_the_last_row():
    """The reference's shard_dataset layout at one rank of a fake
    two-shard mesh: N = 5 pads to 6 with a copy of row 4."""

    class FakeMesh:
        mesh_dim_names = ("data",)
        device_type = "cpu"

        def size(self, i):
            return 2

        def get_coordinate(self):
            return [1]

    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    sh, pad = D.shard_dataset(x, FakeMesh(), ("data",))
    assert pad == 1 and sh.n == 6
    assert torch.equal(sh.local, _t(x[[3, 4, 4]]))
    with pytest.raises(ValueError, match="divisible"):
        D.local_block(x, FakeMesh(), ("data",))


def test_four_rank_solve_matches_the_reference_four_device_mesh(
        solve_inputs, solve_runs, tmp_path):
    """The reference's make_distributed_kmeans (dense) on a (2, 2) mesh
    of four virtual CPU devices, in a subprocess as its own
    tests/test_distributed.py runs it, against the port's four ranks on a
    (2, 2) mesh over ("pod", "data"): labels equal, energy 1e-5, n_iter
    within 2."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    np.savez(tmp_path / "in.npz", **solve_inputs)
    code = f"""
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import make_distributed_kmeans, shard_dataset
from repro.core.kmeans import KMeansConfig
f = np.load({str(tmp_path / "in.npz")!r})
mesh = jax.make_mesh((2, 2), ("pod", "data"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
x, _ = shard_dataset(f["x"], mesh, ("pod", "data"))
fit = make_distributed_kmeans(mesh, KMeansConfig(k={K}, max_iter={MAX_ITER}),
                              ("pod", "data"))
res = fit(x, jnp.asarray(f["c0"]))
np.savez({str(tmp_path / "out.npz")!r}, labels=np.asarray(res.labels),
         energy=np.asarray(res.energy), n_iter=np.asarray(res.n_iter))
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    got = solve_runs["W4-pod-data"][0]["dense"]
    assert np.array_equal(got[1].numpy(), ref["labels"])
    assert float(got[2]) == pytest.approx(float(ref["energy"]), rel=1e-5)
    assert abs(int(got[3]) - int(ref["n_iter"])) <= 2
