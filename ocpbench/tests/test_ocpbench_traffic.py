"""The pools repeat exactly for a seed and follow the traffic file."""

import numpy as np
import pytest

from ocpbench import spec, traffic
from ocpbench.reference import ocp


def pool(cell, seed):
    return traffic.draw(cell.traffic, seed, cell.reference)


def flat(p):
    return np.concatenate([q.delta.ravel() for call in p for q in call])


CELLS = ("bryson.sweep512", "hyper.hp_ph", "hyper.sweep256")


def test_pools_repeat_for_a_seed(bench_root):
    for name in CELLS:
        cell = spec.resolve(name, bench_root.path)
        big = 2 ** 31 + 987654321
        a, b, c = pool(cell, big), pool(cell, big), pool(cell, big + 1)
        assert np.array_equal(flat(a), flat(b))
        assert not np.array_equal(flat(a), flat(c))
        assert len(a) == cell.traffic["pool"]
        for call in a:
            for p, spec_p in zip(call, cell.traffic["perturb"]):
                assert p.delta.shape == (cell.traffic["batch"], len(spec_p["states"]))
                size = spec_p["spread"] * (np.abs(ocp.pinned(cell.reference, p.point, p.phase, p.states))
                                           if spec_p.get("relative") else 1.0)
                assert np.all(np.abs(p.delta) <= size)


def strata(u, k):
    return sorted(np.floor((u + 1.0) / 2.0 * k).astype(int).ravel())


@pytest.mark.parametrize("name", CELLS)
def test_one_rule_of_nested_strata(bench_root, name):
    """Every cell: each call holds one draw in each of B strata, the pool
    one in each of P * B (with B = 1 the pool's calls span the range)."""
    cell = spec.resolve(name, bench_root.path)
    P, B = cell.traffic["pool"], cell.traffic["batch"]
    for seed in (0, 2 ** 33 + 5):
        p = pool(cell, seed)
        for j, spec_p in enumerate(cell.traffic["perturb"]):
            size = spec_p["spread"] * (np.abs(ocp.pinned(cell.reference, spec_p["point"], 0,
                                                          spec_p["states"]))
                                       if spec_p.get("relative") else 1.0)
            u = np.stack([call[j].delta for call in p]) / size         # (P, B, k)
            for s in range(u.shape[2]):
                for i in range(P):
                    assert strata(u[i, :, s], B) == list(range(B))
                assert strata(u[:, :, s], P * B) == list(range(P * B))


def test_uniform_strata_at_odd_shapes():
    g = traffic.rng(11)
    u = traffic.uniform(g, (3, 5, 2))
    assert np.all(np.abs(u) < 1.0)
    for s in range(2):
        assert strata(u[:, :, s], 15) == list(range(15))
        assert all(strata(u[i, :, s], 5) == list(range(5)) for i in range(3))


def test_negative_seed_is_a_seed(bench_root):
    cell = spec.resolve("bryson.sweep512", bench_root.path)
    assert np.array_equal(flat(pool(cell, -5)), flat(pool(cell, -5)))


def test_set_seed_gives_every_seed_the_same_instances(bench_root):
    """With ``set_seed`` the seed deals each call's instances to its lanes
    and changes nothing else: every seed solves the same calls."""
    cell = spec.resolve("bryson.sweep512", bench_root.path)
    assert "set_seed" in cell.traffic
    a, b = pool(cell, 2 ** 31 + 7), pool(cell, 12)
    assert not np.array_equal(flat(a), flat(b))
    for ca, cb in zip(a, b):
        inst = lambda call: sorted(map(tuple, np.concatenate([q.delta for q in call], axis=1)))
        assert inst(ca) == inst(cb)
