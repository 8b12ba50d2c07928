"""The port's Table 3 seedings (afk-mc2, bf, clarans) against the JAX
package's, and the port's benches of Tables 2 and 3 at a tiny scale.

JAX's threefry draws cannot be matched from a ``torch.Generator``, so
the seedings are held to their invariants: shape, determinism per seed,
seeds that are distinct rows of X (of clarans's sample), the reference's
errors, and a seed energy (sum of squared distances to the nearest seed)
within a factor 1.25 of the reference's, each side averaged over the
same three fixed seeds (measured: 0.92-1.00).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_schemes as jinit
from repro.data.synthetic import make_dataset
from repro_torch.core import AAKMeans
from repro_torch.core.init_schemes import (INIT_SCHEMES, afkmc2_init,
                                           batched_init, bf_init,
                                           clarans_init, random_init)

torch.set_num_threads(2)

NEW = {"afk-mc2": afkmc2_init, "bf": bf_init, "clarans": clarans_init}


def _x(n=400, d=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", sorted(NEW))
def test_shape_and_determinism(name):
    x = torch.from_numpy(_x())
    a = NEW[name](_gen(3), x, 5)
    b = NEW[name](_gen(3), x, 5)
    c = NEW[name](_gen(4), x, 5)
    assert a.shape == (5, 4) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["afk-mc2", "clarans"])
def test_seeds_are_distinct_rows(name):
    """afk-mc2 picks rows of X; clarans's medoids are rows of its sample
    (X itself when N <= sample_n), and a swap never duplicates a medoid
    it keeps (it would not lower the cost)."""
    x = _x(n=300, d=3, seed=1)
    c = NEW[name](_gen(), torch.from_numpy(x), 12).numpy()
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c.tolist())
    assert len({tuple(r) for r in c.tolist()}) == 12


def test_clarans_draws_from_its_sample():
    x = torch.from_numpy(_x(n=3000, d=3, seed=2))
    c = clarans_init(_gen(), x, 6, num_local=1, max_neighbor=8,
                     sample_n=256)
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c.tolist())


def test_clarans_counts_its_trials():
    """Each local search ends after max_neighbor rejected swaps in a row,
    so a call makes at least num_local * max_neighbor trials; the count
    is the last call's."""
    from repro_torch.core import init_schemes
    x = torch.from_numpy(_x(n=300, d=3, seed=2))
    clarans_init(_gen(), x, 6, num_local=3, max_neighbor=8)
    many = init_schemes.clarans_trials
    clarans_init(_gen(), x, 6, num_local=1, max_neighbor=4)
    few = init_schemes.clarans_trials
    assert many >= 3 * 8 and 4 <= few < many


@pytest.mark.parametrize("name", sorted(NEW))
def test_validate_seeding_errors_match_jax(name):
    x = _x(n=8, d=3)
    for k, match in ((9, "k <= n"), (0, "at least one cluster")):
        with pytest.raises(ValueError, match=match) as got:
            NEW[name](_gen(), torch.from_numpy(x), k)
        with pytest.raises(ValueError) as want:
            jinit.INIT_SCHEMES[name](jax.random.PRNGKey(0), jnp.asarray(x),
                                     k)
        assert str(got.value) == str(want.value)


def test_clarans_rejects_zero_num_local():
    x = _x(n=64, d=3)
    with pytest.raises(ValueError, match="num_local") as got:
        clarans_init(_gen(), torch.from_numpy(x), 4, num_local=0)
    with pytest.raises(ValueError) as want:
        jinit.clarans_init(jax.random.PRNGKey(0), jnp.asarray(x), 4,
                           num_local=0)
    assert str(got.value) == str(want.value)


def test_scheme_names_are_the_references():
    assert sorted(INIT_SCHEMES) == sorted(jinit.INIT_SCHEMES)


@pytest.mark.parametrize("name", sorted(NEW))
def test_batched_init_takes_the_new_names(name):
    x = torch.from_numpy(_x(n=200, d=3, seed=4))
    a = batched_init(name, _gen(1), x, 4, 2)
    assert a.shape == (2, 4, 3)
    assert torch.equal(a, batched_init(name, _gen(1), x, 4, 2))
    per = batched_init(name, _gen(1), x.expand(2, 200, 3), 4, 2)
    assert per.shape == (2, 4, 3)
    with pytest.raises(ValueError, match="weighted schemes"):
        batched_init(name, _gen(), x, 4, 2, weights=torch.ones(2, 200))


@pytest.mark.parametrize("name", sorted(INIT_SCHEMES))
def test_estimator_fits_with_every_scheme(name):
    x = make_dataset("Colorment", scale=0.02)
    m = AAKMeans(n_clusters=6, init=name, n_init=2, device="cpu").fit(x)
    assert m.centroids_.shape == (6, 9) and np.isfinite(m.inertia_)
    assert m.n_iter_ >= 1 and m.predict(x).shape == (x.shape[0],)


def _seed_energy(x, c):
    return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())


@pytest.mark.parametrize("name", sorted(NEW))
def test_seed_energy_is_the_references(name):
    x = make_dataset("Colorment", scale=0.03)
    ours = np.mean([_seed_energy(x, NEW[name](_gen(s), torch.from_numpy(x),
                                              10).numpy())
                    for s in range(3)])
    theirs = np.mean([_seed_energy(x, np.asarray(jinit.INIT_SCHEMES[name](
        jax.random.PRNGKey(s), jnp.asarray(x), 10))) for s in range(3)])
    assert 1 / 1.25 <= ours / theirs <= 1.25, (ours, theirs)
    # every scheme beats uniform random rows on this overlapping data
    rand = np.mean([_seed_energy(x, random_init(
        _gen(s), torch.from_numpy(x), 10).numpy()) for s in range(3)])
    assert ours < rand


# -- the benches -------------------------------------------------------------

def test_table3_bench_runs_on_the_cpu():
    from benchmarks_torch import table3_vs_lloyd
    for backend in ("dense", "fused"):
        s = table3_vs_lloyd.run(scale=0.01, datasets=["Eb"], backend=backend,
                                device="cpu", verbose=False, reps=1)
        assert {"wins", "iter_wins", "total", "mean_time_decrease",
                "mse_parity", "cases"} <= set(s)
        assert s["total"] == len(s["cases"]) == 5
        assert 0 <= s["wins"] <= s["total"]
        assert 0 <= s["iter_wins"] <= s["total"]
        assert 0 <= s["mse_parity"] <= s["total"]
        assert {c["init"] for c in s["cases"]} == set(table3_vs_lloyd.INITS)
        assert all(c["lloyd_iter"] >= 1 and c["aa_b"] >= 1
                   and np.isfinite(c["aa_mse"]) for c in s["cases"])


def test_table2_bench_runs_on_the_cpu(tmp_path):
    from benchmarks_torch import common, table2_dynamic_m
    s = table2_dynamic_m.run(scale=0.01, datasets=["Colorment"],
                             device="cpu", verbose=False, reps=1)
    assert {"wins_dynamic_m2", "wins_dynamic_m5", "total", "rows"} <= set(s)
    assert s["total"] == len(s["rows"]) == 1
    assert 0 <= s["wins_dynamic_m2"] <= 1 and 0 <= s["wins_dynamic_m5"] <= 1
    row = s["rows"][0]
    assert row["dyn_m5"]["max_m"] >= 5 and row["dyn_m2"]["mean_m"] > 0
    out = tmp_path / "t2.json"
    common.record(out, "table2_dynamic_m", s, scale=0.01, cuts={},
                  backend="dense", device=torch.device("cpu"),
                  complete=True, notes="")
    assert '"wins_dynamic_m2"' in out.read_text()


def test_benches_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from benchmarks_torch import table2_dynamic_m
    with pytest.raises(RuntimeError):
        table2_dynamic_m.run(scale=0.01, datasets=["Colorment"])
