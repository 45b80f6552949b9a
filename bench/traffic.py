"""The one traffic generator: a mix file's parameters and a seed in, the
requests or frames of one run out.

Every seed gets the same work in nearly the same order. The lengths are
the quantiles of the mix's clipped lognormal at ``(i + 0.5) / n`` and the
gaps between arrivals the quantiles of the exponential (``n`` the mean
rate times the span), each set put in one order drawn from a fixed
stream. A seed then permutes the sizes among each run of ``LOCAL``
consecutive arrivals and draws the token ids. With requests that last
half the window, where the seed put the longest ones would move the count
of tokens that finish inside the window by 3-5 % from seed to seed
(simulated, and measured on the card); moved among neighbours, by well
under 1 %.

A serving mix's ``lead_s`` (default 0) adds that many seconds of the
same arrivals before the window opens, due at negative times: the
engine is brought to the load it carries in steady state during set-up,
so that the window does not measure the ramp from an empty engine.

Arrivals (``arrivals.kind``):
  - ``poisson``: gaps of mean ``1 / rate_per_s`` over the whole span;
  - ``on_off``: cycles of ``on_s`` seconds of arrivals and ``off_s``
    seconds of none, the on-rate ``rate_per_s * (on_s + off_s) / on_s``,
    so that the mean over a cycle is ``rate_per_s``.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

LOCAL = 4
BASE = 0            # the fixed stream of the base order


@dataclasses.dataclass
class Arrival:
    """One request of a serving mix: when it is due (seconds after the
    window opens, negative in the lead-in), its prompt's token ids and how
    many tokens to emit."""
    index: int
    due_s: float
    prompt: list[int]
    max_new_tokens: int


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's data (``seed`` any whole
    number, however large)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def lengths(dist: dict, n: int, gen: np.random.Generator) -> list[int]:
    """``n`` lengths of a clipped lognormal (``median``, ``sigma``,
    ``min``, ``max``): its quantiles at (i + 0.5) / n, in an order drawn
    from ``gen``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    normal = NormalDist()
    values = [min(dist["max"], max(dist["min"], round(
        dist["median"] * math.exp(dist["sigma"] * normal.inv_cdf(
            (i + 0.5) / n))))) for i in range(n)]
    return [values[i] for i in gen.permutation(n)]


def arrival_times(spec: dict, seconds: float, gen: np.random.Generator
                  ) -> list[float]:
    """Due times in [0, seconds), sorted, for the mix's ``arrivals``."""
    rate = spec["rate_per_s"]
    n = max(1, round(rate * seconds))
    kind = spec["kind"]
    if kind == "poisson":
        span, on, cycle = seconds, seconds, seconds
    elif kind == "on_off":
        on, cycle = spec["on_s"], spec["on_s"] + spec["off_s"]
        whole, part = divmod(seconds, cycle)
        span = whole * on + min(part, on)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    gaps = -np.log(1.0 - (gen.permutation(n) + 0.5) / n)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * (span / gaps.sum())
    return [float(c * cycle + r) for c, r in zip(*np.divmod(t, on))]


def requests(mix: dict, seconds: float, seed: int, vocab: int
             ) -> list[Arrival]:
    """The serving requests of one run, in the order they are due: the
    mix's ``lead_s`` seconds of them before the window opens (due before
    0), then ``seconds`` of them in the window."""
    lead = mix.get("lead_s", 0.0)
    due = [t - lead for t in
           arrival_times(mix["arrivals"], lead + seconds, rng(BASE, 0))]
    n = len(due)
    prompts = lengths(mix["prompt"], n, rng(BASE, 1))
    outputs = lengths(mix["output"], n, rng(BASE, 2))
    gen = rng(seed, 6)
    order = [b + j for b in range(0, n, LOCAL)
             for j in gen.permutation(min(LOCAL, n - b))]
    ids = rng(seed, 3)
    return [Arrival(i, due[i], ids.integers(0, vocab, prompts[k]).tolist(),
                    outputs[k]) for i, k in enumerate(order)]


def frames(mix: dict, seconds: float, seed: int, vocab: int) -> list:
    """The chain's frames of one run: ``ceil(seconds / frame_period_s)``
    arrays of (batch, tokens_per_frame) int32 token ids, all different,
    all available from the start (a saturating closed loop)."""
    n = max(1, math.ceil(seconds / mix["frame_period_s"]))
    gen = rng(seed, 4)
    shape = (mix["batch"], mix["tokens_per_frame"])
    return [gen.integers(0, vocab, shape).astype(np.int32) for _ in range(n)]
