"""The one generator of traffic: a pool of perturbed instances drawn from
the seed, as the traffic file's parameters say.

A traffic file (``ocpbench/traffic/<name>.json``) holds:

- ``mode``: ``"sweep"`` (each call solves ``batch`` instances in lockstep on
  a fixed mesh) or ``"hp"`` (each call is one hp-adaptive solve);
- ``mesh``: ``{"degrees": [...], "fractions": [...] or null}`` (null: equal
  segments), the fixed mesh of a sweep or the first mesh of an hp solve;
- ``batch``, ``pool`` (calls drawn, then cycled through), ``max_iter``;
- ``perturb``: a list of ``{"point": "x0" | "xf", "phase": 0, "states":
  [...], "spread": s, "relative": bool}``: each listed state, pinned at
  that point, is moved by ``s * U(-1, 1)``, times its nominal value where
  ``relative``;
- ``trace_calls``: the calls a traced run profiles after its window;
- ``set_seed`` (optional): the instances are those that this fixed seed
  draws, the same set of calls for every ``--seed``, which then only deals
  each call's instances to its lanes in an order of its own. A lockstep
  sweep lasts as long as its slowest instance, and where several states are
  moved at once the strata of each alone do not fix which pairs a seed
  draws, so a slow pair may or may not be drawn: with ``set_seed`` every
  seed does the same work.

This module is the frozen copy of the perturbations of ``chip_smoke.py``
(``sweep_inputs``: the terminal target moved by ``0.2 * U(-1, 1) *
var_scale``) and of the JAX package's ``bench.py`` (``perturb_x0``), for a
configuration without variable scaling (``var_scale`` = 1). The deltas are
in the problem's own units; the same deltas go to the program and to the
reference.

Every U(-1, 1) is drawn in nested equal strata, as a dispersion study
draws a Latin hypercube: over a pool of P calls of B instances, each call
holds one draw in each of B equal strata, and the pool one in each of
P * B, in an order of the seed's own. So every seed solves the same set of
instances to within one stratum, and every lockstep sweep, which its
slowest instance times, spans the same range; with B = 1 the pool's calls
span the range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference import ocp


@dataclass(frozen=True)
class Perturbation:
    point: str
    phase: int
    states: tuple
    delta: np.ndarray      # (batch, len(states))


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed`` (any whole number) and ``stream``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def uniform(g: np.random.Generator, shape) -> np.ndarray:
    """U(-1, 1) of ``shape`` (pool P, batch B, k) in nested strata: each
    call a permutation of the B coarse strata, and the P fine strata of
    each coarse one dealt to the calls in an order of the seed's own."""
    P, B, K = shape
    coarse = np.argsort(g.uniform(size=shape), axis=1)              # (P, B, K)
    fine = np.argsort(g.uniform(size=(B, P, K)), axis=1)            # (B, P, K)
    sub = fine[coarse, np.arange(P)[:, None, None], np.arange(K)[None, None, :]]
    return -1.0 + 2.0 * (coarse * P + sub + g.uniform(size=shape)) / (P * B)


def draw(traffic: dict, seed: int, reference) -> list:
    """The pool: one list of :class:`Perturbation` per call. ``reference``
    gives the nominal values of the relative spreads (``ocp.pinned``)."""
    fixed = traffic.get("set_seed")
    g = rng(seed if fixed is None else int(fixed))
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    if fixed is None:
        lanes = np.tile(np.arange(batch), (pool, 1))
    else:
        h = rng(seed, 1)
        lanes = np.stack([h.permutation(batch) for _ in range(pool)])
    calls = [[] for _ in range(pool)]
    for p in traffic["perturb"]:
        states = tuple(int(s) for s in p["states"])
        lo = ocp.pinned(reference, p["point"], int(p.get("phase", 0)), states)
        u = uniform(g, (pool, batch, len(states)))
        d = float(p["spread"]) * u * (np.abs(lo)[None, None, :] if p.get("relative") else 1.0)
        for i in range(pool):
            calls[i].append(Perturbation(p["point"], int(p.get("phase", 0)), states, d[i][lanes[i]]))
    return calls
