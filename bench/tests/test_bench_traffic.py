"""The seeded generators: arrivals, lengths, prompts and crash victims."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from bench import faults, traffic

BENCH = Path(__file__).resolve().parents[1]
BIG_SEED = 2**31 + 12345


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["longdoc", "longdoc64k"])
def test_schedule_repeats_exactly(name):
    a = traffic.schedule(mix(name), BIG_SEED, 45.0, 4)
    b = traffic.schedule(mix(name), BIG_SEED, 45.0, 4)
    assert a == b
    assert traffic.schedule(mix(name), BIG_SEED + 1, 45.0, 4) != a


@pytest.mark.parametrize("name", ["longdoc", "longdoc64k"])
def test_every_seed_gets_the_same_work(name):
    m = mix(name)
    runs = [traffic.schedule(m, s, 45.0, 4) for s in (1, 2, BIG_SEED)]
    n = int(round(m["rate_rps"] * 45.0))
    for run in runs:
        assert len(run) == n
        assert all(0.0 <= a.t_due < 45.0 for a in run)
        assert [a.t_due for a in run] == sorted(a.t_due for a in run)
        lo, hi = m["prompt"]["min"], m["prompt"]["max"]
        assert all(lo <= a.prompt_len <= hi for a in run)
        assert all(1 <= a.new_tokens <= 8 for a in run)
        counts = Counter(a.app for a in run)
        assert max(counts.values()) - min(counts.values()) <= 1
    keys = [sorted((a.prompt_len, a.new_tokens) for a in run)
            for run in runs]
    assert sorted(a.prompt_len for a in runs[0]) == \
        sorted(a.prompt_len for a in runs[1])
    assert sorted(a.new_tokens for a in runs[0]) == \
        sorted(a.new_tokens for a in runs[2])
    gaps = [np.sort(np.diff([a.t_due for a in run])) for run in runs]
    assert keys[0] != [] and np.allclose(gaps[0][1:], gaps[1][1:], atol=5.0)


def test_lengths_follow_their_distributions():
    u = (np.arange(10000) + 0.5) / 10000
    x = traffic._lengths({"dist": "loguniform", "min": 2048, "max": 16384}, u)
    assert x.min() == 2048 and 16370 < x.max() <= 16384
    # half the mass below the geometric mean
    assert abs(np.median(x) - np.sqrt(2048 * 16385)) < 60
    y = traffic._lengths({"dist": "uniform", "min": 1, "max": 8}, u)
    assert Counter(y.tolist()) == {k: 1250 for k in range(1, 9)}


def test_prompts_repeat_by_seed_and_index():
    a = traffic.prompt_tokens(BIG_SEED, 3, 100, 503)
    assert np.array_equal(a, traffic.prompt_tokens(BIG_SEED, 3, 100, 503))
    assert not np.array_equal(a, traffic.prompt_tokens(BIG_SEED, 4, 100, 503))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 503


def test_crash_schedule_and_victims():
    spec = json.loads((BENCH / "faults" / "four-crashes.json").read_text())
    cs = faults.crashes(spec, 50.0)
    assert [c.t for c in cs] == pytest.approx([7.5, 17.5, 27.5, 37.5])
    assert [c.rejoin_t for c in cs] == pytest.approx([12.5, 22.5, 32.5,
                                                      42.5])
    assert [c.target for c in cs] == ["critical", "standard"] * 2
    holders = {"critical": ["s0-0", "s0-1"], "standard": ["s1-0"]}
    p1, p2 = faults.VictimPicker(BIG_SEED), faults.VictimPicker(BIG_SEED)
    picks = [p1.pick("critical", holders) for _ in range(20)]
    assert picks == [p2.pick("critical", holders) for _ in range(20)]
    assert set(picks) == {"s0-0", "s0-1"}
    assert p1.pick("standard", holders) == "s1-0"
    assert p1.pick("standard", {"critical": ["a"], "standard": []}) == "a"
    assert p1.pick("any", {"critical": [], "standard": []}) is None
    assert faults.crashes(json.loads(
        (BENCH / "faults" / "none.json").read_text()), 50.0) == []
