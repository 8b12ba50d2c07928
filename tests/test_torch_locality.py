"""The port's locality engine (repro_torch.core.locality) against the JAX
package's and against its own contract.

* The sorts: ``counting_sort_perm``, ``label_ranks`` and
  ``counting_sort_perm_segmented`` equal the reference's outputs and
  ``np.argsort(kind="stable")`` exactly, with empty clusters, several
  ``sort_tile`` values, padded stripes holding the sentinel N, and a row
  past the last slot dropped.
* The wrapper, all on the CPU: wrapped hamerly / elkan / yinyang solves
  equal the raw solves on every KMeansResult leaf, bit for bit (the
  wrapper recomputes the stats with the engines' own ``stats_fn`` in
  original row order); ``fused_bounds`` (its plain version) sorted on
  every change ("always") equals never sorted ("never") bit for bit, its
  labels equal the raw solve's, also at R = 2; the churn trigger fires
  under "always" and is held off under "never" and a huge warm-up; a
  boundless engine is refused; the registry variants resolve and are
  cached per option set; the wrapped solve's labels equal the
  reference's ``aa_kmeans(..., reorder=True)`` (energies within rtol
  1e-5).
* State carried across: the reference's mid-solve batched state with a
  live permutation (elkan, "always"), through ``interop``; one port trip
  lands on the reference's next state (labels, perm and n_sorts exact,
  energies within rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import locality as jlocality
from repro.core.backends import get_backend as jget_backend
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import _init_batched_state
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.core.kmeans import aa_kmeans_batched as jaa_kmeans_batched
from repro.data.synthetic import make_blobs
from repro_torch.core import get_backend
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_traced,
                                     batched_trip)
from repro_torch.core.locality import (ReorderConfig, counting_sort_perm,
                                       counting_sort_perm_segmented,
                                       inner_carry, label_ranks,
                                       permutation, permute_bound_carry,
                                       reorder_backend, sort_count)
from repro_torch.interop import batched_state_from_numpy
from test_torch_kmeans import _assert_state_close

torch.set_num_threads(2)

NEVER = ReorderConfig(warmup=2, churn_threshold=1.5)   # never sorts
ALWAYS = ReorderConfig(warmup=2, churn_threshold=0.0)  # sorts on any change
BOUND_ENGINES = ["hamerly", "elkan", "yinyang"]


def _problem(seed=3, n=512, d=8, k=8):
    x = make_blobs(n, d, k, seed=seed)
    c0 = x[np.random.default_rng(0).permutation(n)[:k]]
    return x, c0, k


def _leaves_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


# -- the sorts ----------------------------------------------------------------

def _jsorted(labels, k, sort_tile):
    perm, inv = jlocality.counting_sort_perm(jnp.asarray(labels), k,
                                             sort_tile=sort_tile)
    ranks = jlocality.label_ranks(jnp.asarray(labels), k,
                                  sort_tile=sort_tile)
    return np.asarray(perm), np.asarray(inv), np.asarray(ranks)


@pytest.mark.parametrize("sort_tile", [None, 1, 3, 64])
def test_counting_sort_matches_jax_and_stable_argsort(sort_tile):
    rng = np.random.default_rng(0 if sort_tile is None else sort_tile)
    # (n, k, labels drawn from the first hi): few labels of many leave
    # most clusters empty
    for n, k, hi in ((1, 1, 1), (37, 5, 5), (300, 40, 8), (300, 3, 3),
                     (150, 12, 12)):
        labels = rng.integers(0, hi, size=n).astype(np.int32)
        perm, inv = counting_sort_perm(torch.from_numpy(labels), k,
                                       sort_tile=sort_tile)
        ranks = label_ranks(torch.from_numpy(labels), k,
                            sort_tile=sort_tile)
        jperm, jinv, jranks = _jsorted(labels, k, sort_tile)
        expect = np.argsort(labels, kind="stable")
        np.testing.assert_array_equal(perm.numpy(), expect)
        np.testing.assert_array_equal(perm.numpy(), jperm)
        np.testing.assert_array_equal(inv.numpy(), jinv)
        np.testing.assert_array_equal(ranks.numpy(), jranks)
        assert perm.dtype == inv.dtype == ranks.dtype == torch.int32


def test_counting_sort_ties_and_empty_clusters():
    labels = np.array([5, 5, 0, 9, 5, 0], np.int32)
    perm, inv = counting_sort_perm(torch.from_numpy(labels), 12,
                                   sort_tile=1)
    jperm, jinv, _ = _jsorted(labels, 12, 1)
    np.testing.assert_array_equal(perm.numpy(), [2, 5, 0, 1, 4, 3])
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(inv.numpy(), jinv)


def test_counting_sort_batched_rows_sort_each_row():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, size=(3, 50)).astype(np.int32)
    perm, inv = counting_sort_perm(torch.from_numpy(labels), 6)
    for i in range(3):
        np.testing.assert_array_equal(perm[i].numpy(),
                                      np.argsort(labels[i], kind="stable"))
        np.testing.assert_array_equal(perm[i].numpy()[inv[i].numpy()],
                                      np.arange(50))


def _jsegmented(labels, k, offsets, out_size, sort_tile=None):
    out = jlocality.counting_sort_perm_segmented(
        jnp.asarray(labels), k, jnp.asarray(offsets, np.int32), out_size,
        sort_tile=sort_tile)
    return [np.asarray(a) for a in out]


def test_segmented_tight_pack_matches_jax():
    rng = np.random.default_rng(1)
    for n, k in ((1, 1), (40, 3), (149, 11)):
        labels = rng.integers(0, k, size=n).astype(np.int32)
        counts = np.bincount(labels, minlength=k)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int32)
        got = counting_sort_perm_segmented(
            torch.from_numpy(labels), k, torch.from_numpy(offsets), n)
        for g, w in zip(got, _jsegmented(labels, k, offsets, n)):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.argsort(labels, kind="stable"))
        np.testing.assert_array_equal(got[2].numpy(), counts)


@pytest.mark.parametrize("sort_tile", [None, 2])
def test_segmented_padded_stripes_hold_the_sentinel(sort_tile):
    labels = np.array([2, 0, 2, 1, 0, 2], np.int32)
    stride, k, n = 4, 3, 6
    offsets = np.arange(k, dtype=np.int32) * stride
    perm, inv, cnt = counting_sort_perm_segmented(
        torch.from_numpy(labels), k, torch.from_numpy(offsets), k * stride,
        sort_tile=sort_tile)
    for g, w in zip((perm, inv, cnt),
                    _jsegmented(labels, k, offsets, k * stride, sort_tile)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        perm.numpy(), [1, 4, n, n, 3, n, n, n, 0, 2, 5, n])
    np.testing.assert_array_equal(inv.numpy(), [8, 0, 9, 4, 1, 10])
    np.testing.assert_array_equal(cnt.numpy(), [2, 1, 3])


def test_segmented_drops_rows_past_the_last_slot():
    """Label 1's stripe holds two slots before the end: its third row
    lands at slot 6 of 6 and is dropped from perm, as in the reference."""
    labels = np.array([1, 0, 1, 1], np.int32)
    offsets = np.array([0, 4], np.int32)
    got = counting_sort_perm_segmented(torch.from_numpy(labels), 2,
                                       torch.from_numpy(offsets), 6)
    for g, w in zip(got, _jsegmented(labels, 2, offsets, 6)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[0].numpy(), [1, 4, 4, 4, 0, 2])
    np.testing.assert_array_equal(got[1].numpy(), [4, 0, 5, 6])


def test_permute_bound_carry_moves_rows_in_lockstep():
    rng = np.random.default_rng(2)
    carry = get_backend("elkan", group_size=3).init_carry(
        torch.zeros(20, 2), torch.zeros(7, 2), 7)
    carry = (torch.from_numpy(rng.integers(0, 7, 20).astype(np.int32)),
             torch.rand(20), torch.rand(20, 3), carry[3], carry[4])
    idx = torch.from_numpy(rng.permutation(20).astype(np.int32))
    got = permute_bound_carry(carry, idx)
    for a, b in zip(got[:3], carry[:3]):
        assert torch.equal(a, b[idx.long()])
    assert got[3] is carry[3] and got[4] is carry[4]


# -- the wrapper --------------------------------------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("name", BOUND_ENGINES)
def test_wrapped_solve_equals_raw_bitwise(name):
    x, c0, k = _problem()
    cfg = KMeansConfig(k=k, max_iter=40)
    raw = aa_kmeans(*_t(x, c0), cfg, backend=name)
    for reorder in (True, ALWAYS):
        assert _leaves_equal(raw, aa_kmeans(*_t(x, c0), cfg, backend=name,
                                            reorder=reorder))


def test_fused_bounds_always_equals_never_and_labels_equal_raw():
    x, c0, k = _problem()
    cfg = KMeansConfig(k=k, max_iter=40)
    bk = get_backend("fused_bounds", group_size=2)
    raw = aa_kmeans(*_t(x, c0), cfg, backend=bk)
    never = aa_kmeans(*_t(x, c0), cfg, backend=bk, reorder=NEVER)
    srt = aa_kmeans(*_t(x, c0), cfg, backend=bk, reorder=ALWAYS)
    assert _leaves_equal(never, srt)
    assert torch.equal(raw.labels, srt.labels)


def test_batched_always_equals_never_and_labels_equal_raw():
    x, c0, k = _problem()
    c0s = np.stack([c0, c0[::-1]])
    cfg = KMeansConfig(k=k, max_iter=40)
    bk = get_backend("fused_bounds", group_size=2)
    raw = aa_kmeans_batched(*_t(x, c0s), cfg, backend=bk)
    never = aa_kmeans_batched(*_t(x, c0s), cfg, backend=bk, reorder=NEVER)
    srt = aa_kmeans_batched(*_t(x, c0s), cfg, backend=bk, reorder=ALWAYS)
    assert _leaves_equal(never, srt)
    assert torch.equal(raw.labels, srt.labels)
    # the CPU engines through the per-restart fallback: bitwise vs raw
    raw_e = aa_kmeans_batched(*_t(x, c0s), cfg, backend="elkan")
    assert _leaves_equal(raw_e, aa_kmeans_batched(
        *_t(x, c0s), cfg, backend="elkan", reorder=ALWAYS))


def _carry_probe(name, config, steps=6, seed=3):
    """Drive single-problem wrapper steps; -> the final carry."""
    x, c0, k = _problem(seed=seed)
    xt, c = _t(x, c0)
    bk = reorder_backend(get_backend(name), config)
    carry = bk.init_carry(xt, c, k)
    for _ in range(steps):
        res, carry = bk.step(xt, c, k, carry)
        c = bk.centroids_from_step(xt, res, k, c)
    return carry


@pytest.mark.parametrize("name", ["elkan", "fused_bounds"])
def test_churn_trigger_fires(name):
    carry = _carry_probe(name, ALWAYS)
    assert int(sort_count(carry)) > 0
    assert not torch.equal(permutation(carry), torch.arange(
        512, dtype=torch.int32))
    # perm sorts the labels of the last sort
    labels_sort = carry[2]
    assert bool((torch.diff(labels_sort[permutation(carry).long()])
                 >= 0).all())


@pytest.mark.parametrize("config", [NEVER, ReorderConfig(warmup=10 ** 6)],
                         ids=["never", "huge-warmup"])
def test_churn_trigger_held_off(config):
    carry = _carry_probe("elkan", config)
    assert int(sort_count(carry)) == 0
    assert torch.equal(permutation(carry),
                       torch.arange(512, dtype=torch.int32))


def test_wrapper_rejects_boundless_inner():
    x, c0, k = _problem()
    with pytest.raises(TypeError, match="bound-carrying"):
        reorder_backend(get_backend("dense")).init_carry(*_t(x, c0), k)


def test_wrapper_refuses_weighted_batched_steps():
    x, c0, k = _problem()
    bk = reorder_backend(get_backend("elkan"))
    xt, c0s = torch.from_numpy(x), torch.from_numpy(c0[None])
    with pytest.raises(TypeError, match="weighted"):
        bk.batched_step(xt, c0s, k, bk.batched_init_carry(xt, c0s, k),
                        w=torch.ones(1, 512))


def test_registry_variants_resolve_and_are_cached():
    for name in BOUND_ENGINES + ["fused_bounds"]:
        assert get_backend(f"{name}_reorder").name == f"{name}+reorder"
    bk = get_backend("elkan_reorder", warmup=5, churn_threshold=0.5)
    assert bk is not get_backend("elkan_reorder")       # another policy
    assert get_backend("elkan_reorder") is get_backend("elkan_reorder")
    assert get_backend("elkan_reorder", warmup=5, churn_threshold=0.5) is bk
    assert reorder_backend(get_backend("elkan"), ReorderConfig()) is \
        get_backend("elkan_reorder")
    # inner options reach the inner factory
    gs = get_backend("fused_bounds_reorder", group_size=16, sort_tile=4)
    assert gs is reorder_backend(get_backend("fused_bounds", group_size=16),
                                 ReorderConfig(sort_tile=4))


def test_traced_driver_with_reorder_reports_bound_stats():
    x, c0, k = _problem()
    cfg = KMeansConfig(k=k, max_iter=40)
    tr = aa_kmeans_traced(*_t(x, c0), cfg, backend="elkan", reorder=ALWAYS)
    raw = aa_kmeans_traced(*_t(x, c0), cfg, backend="elkan")
    assert len(tr.bound_stats) == len(tr.energies) > 0
    assert tr.bound_stats == raw.bound_stats
    assert _leaves_equal(tr.result, raw.result)


@pytest.mark.parametrize("name", BOUND_ENGINES + ["fused_bounds"])
def test_wrapped_solve_labels_match_jax(name):
    x, c0, k = _problem()
    got = aa_kmeans(*_t(x, c0), KMeansConfig(k=k, max_iter=40),
                    backend=name, reorder=True)
    want = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0),
                      JKMeansConfig(k=k, max_iter=40), backend=name,
                      reorder=True)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-5)


# -- state carried across -----------------------------------------------------

def test_one_trip_from_reference_state_with_a_live_permutation():
    x, c0, k = _problem()
    c0s = np.stack([c0, c0[::-1]])
    jbk = jlocality.reorder_backend(jget_backend("elkan"),
                                    jlocality.ReorderConfig(
                                        warmup=2, churn_threshold=0.0))
    jcfg = JKMeansConfig(k=k, max_iter=40)
    states = [jax.device_get(_init_batched_state(
        jnp.asarray(x), jnp.asarray(c0s), jcfg, jbk, None))]
    jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg, backend=jbk,
                       checkpoint_every=1,
                       checkpoint_cb=lambda bst, _: states.append(
                           jax.device_get(bst)))
    live = [i for i, s in enumerate(states[:-1])
            if np.asarray(s.inner.carry[4]).min() > 0]
    assert live, "the reference never sorted"
    cfg = KMeansConfig(k=k, max_iter=40)
    bk = reorder_backend(get_backend("elkan"), ALWAYS)
    xt = torch.from_numpy(x)
    for i in live:
        start = batched_state_from_numpy(states[i], "cpu")
        perm0 = permutation(start.inner.carry)
        assert not torch.equal(perm0[0], torch.arange(512,
                                                      dtype=torch.int32))
        got = batched_trip(xt, start, cfg, bk)
        want = states[i + 1]
        _assert_state_close(got, want, f"after trip {i + 1}")
        for j in (0, 1, 2, 3, 4):          # perm, inv, labels_sort, t, n
            np.testing.assert_array_equal(
                got.inner.carry[j].numpy(), np.asarray(want.inner.carry[j]),
                err_msg=f"reorder carry leaf {j} after trip {i + 1}")
        np.testing.assert_array_equal(
            inner_carry(got.inner.carry)[0].numpy(),
            np.asarray(want.inner.carry[5][0]))
