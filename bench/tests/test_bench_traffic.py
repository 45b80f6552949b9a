"""The traffic generator: the same seed gives the same arrivals and
lengths; every seed gets the same sizes and gaps in nearly the same
order; the Poisson and on/off means hold; a lead-in precedes the
window."""
import math

import numpy as np
import pytest
import smoke  # noqa: F401  (puts the checkout on the path)

from bench import traffic

MIX = {"arrivals": {"kind": "poisson", "rate_per_s": 6.8},
       "prompt": {"dist": "lognormal", "median": 256, "sigma": 1.0,
                  "min": 32, "max": 768},
       "output": {"dist": "lognormal", "median": 64, "sigma": 0.8,
                  "min": 8, "max": 192}}
BURSTY = {**MIX, "arrivals": {"kind": "on_off", "rate_per_s": 7.3,
                              "on_s": 2.0, "off_s": 3.0}}
SEED = 2**31 + 12345                     # larger than 32 signed bits


def as_tuple(reqs):
    return [(r.due_s, tuple(r.prompt), r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("mix", [MIX, BURSTY], ids=["poisson", "on_off"])
def test_same_seed_same_requests(mix):
    a = traffic.requests(mix, 30.0, SEED, 32064)
    b = traffic.requests(mix, 30.0, SEED, 32064)
    c = traffic.requests(mix, 30.0, SEED + 1, 32064)
    assert as_tuple(a) == as_tuple(b)
    assert as_tuple(a) != as_tuple(c)


@pytest.mark.parametrize("mix", [MIX, BURSTY], ids=["poisson", "on_off"])
def test_every_seed_gets_the_same_work(mix):
    """The same sizes; the same arrivals; sizes moved among neighbours."""
    a = traffic.requests(mix, 30.0, 1, 32064)
    b = traffic.requests(mix, 30.0, 987654321987, 32064)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert sorted(r.max_new_tokens for r in a) == sorted(
        r.max_new_tokens for r in b)
    assert [r.due_s for r in a] == [r.due_s for r in b]
    moved = [i for i, (x, y) in enumerate(zip(a, b))
             if (len(x.prompt), x.max_new_tokens)
             != (len(y.prompt), y.max_new_tokens)]
    assert moved        # the seed reorders sizes, within runs of LOCAL
    for lo in range(0, len(a), traffic.LOCAL):
        run = slice(lo, lo + traffic.LOCAL)
        assert sorted((len(r.prompt), r.max_new_tokens) for r in a[run]) \
            == sorted((len(r.prompt), r.max_new_tokens) for r in b[run])


def test_poisson_mean_rate_and_lengths():
    reqs = traffic.requests(MIX, 40.0, 3, 32064)
    due = np.array([r.due_s for r in reqs])
    assert len(reqs) == round(6.8 * 40.0)
    assert (np.diff(due) >= 0).all() and due[0] == 0.0 and due[-1] < 40.0
    assert math.isclose(np.diff(due).mean(), 1 / 6.8, rel_tol=0.02)
    prompts = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new_tokens for r in reqs])
    assert prompts.min() >= 32 and prompts.max() == 768
    assert outs.min() >= 8 and outs.max() <= 192
    assert abs(np.median(prompts) - 256) <= 3
    assert abs(np.median(outs) - 64) <= 2
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 32064


def test_on_off_bursts():
    seconds = 30.0
    reqs = traffic.requests(BURSTY, seconds, 5, 32000)
    due = np.array([r.due_s for r in reqs])
    assert len(reqs) == round(7.3 * seconds)
    phase = np.mod(due, 5.0)
    assert (phase < 2.0).all(), "an arrival fell in an off phase"
    per_cycle = np.bincount((due // 5.0).astype(int), minlength=6)
    # 2.5 x the mean rate over each 2 s burst, none for 3 s: the mean per
    # cycle holds, each burst's count varies as a Poisson count does
    assert per_cycle.mean() == pytest.approx(7.3 * 5.0, rel=0.01)
    assert ((per_cycle > 0.5 * 7.3 * 5.0) & (per_cycle < 1.5 * 7.3 * 5.0)
            ).all()
    assert math.isclose(len(reqs) / (6 * 2.0), 2.5 * 7.3, rel_tol=0.01)


def test_lead_in_precedes_the_window():
    """``lead_s`` adds that many seconds of the same arrivals, due before
    the window opens; every seed gets them too."""
    mix = {**MIX, "lead_s": 10.0}
    a = traffic.requests(mix, 30.0, SEED, 32064)
    b = traffic.requests(mix, 30.0, 5, 32064)
    due = np.array([r.due_s for r in a])
    assert len(a) == round(6.8 * 40.0)
    assert due[0] == -10.0 and due[-1] < 30.0 and (np.diff(due) >= 0).all()
    assert abs((due >= 0).sum() - 6.8 * 30.0) <= 0.05 * 6.8 * 30.0
    assert [r.due_s for r in a] == [r.due_s for r in b]


def test_frames():
    mix = {"frame_period_s": 0.118, "batch": 1, "tokens_per_frame": 2048}
    a = traffic.frames(mix, 10.0, SEED, 32064)
    b = traffic.frames(mix, 10.0, SEED, 32064)
    assert len(a) == math.ceil(10.0 / 0.118)
    assert all((x == y).all() for x, y in zip(a, b))
    assert a[0].shape == (1, 2048) and a[0].dtype == np.int32
    assert len({x.tobytes() for x in a}) == len(a)
