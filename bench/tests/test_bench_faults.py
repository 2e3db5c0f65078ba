"""The check fails what it should: a whole run on the CPU, with the harness's
look for a card skipped and the timed path broken underneath, reads
``correct`` false, once for each fault a serving cell can have (one card:
no exchange between chips to leave out), and once for a failover plan
altered where it is made; and the control, the reference in fp8 put in the
program's place, reads not correct, past each configuration's limit."""

from __future__ import annotations

import pytest
import torch

from bench import harness
from bench.tests.smoke import smoke_tree

CELLS = ["qwen2.5-3b.longdoc-crash", "rwkv6-3b.longdoc64k-crash"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def stale_state(orig):
    """A decode step that returns its cache unchanged."""
    def f(params, cfg, tokens, cache):
        logits, _ = orig(params, cfg, tokens, _clone(cache))
        return logits, cache
    return f


def half_batch(orig):
    """A decode step that leaves the first half of the slots out and hands
    them the logits of the rest."""
    def f(params, cfg, tokens, cache):
        logits, cache = orig(params, cfg, tokens, cache)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[:h] = logits[h:2 * h]
        return logits, cache
    return f


def altered_token(orig):
    """A decode step whose best token is not the one it produces."""
    def f(params, cfg, tokens, cache):
        logits, cache = orig(params, cfg, tokens, cache)
        logits = logits.clone()
        logits.scatter_(1, logits.argmax(-1, keepdim=True), float("-inf"))
        return logits, cache
    return f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_token])
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch, cell,
                                               fault):
    from repro_torch.models import model as MDL
    root = smoke_tree(tmp_path)
    monkeypatch.setattr(MDL, "decode_step", fault(MDL.decode_step))
    out = harness.run_cell(cell, 2**31 + 99, 3.0, False, device="cpu",
                           root=root, bench_json=tmp_path / "BENCHMARK.json")
    gap = out["checks"]["logit_gap"]
    assert not out["correct"]
    assert gap["value"] > gap["limit"], gap


def worse_rung(orig):
    """A planner that places each application's first placed rung one
    rung lower than it chose, where there is one."""
    def f(apps, cluster=None, **kw):
        res = orig(apps, cluster, **kw)
        for app in apps:
            if app.id in res.assignment:
                v, sid = res.assignment[app.id]
                j = app.variants.index(v)
                if j + 1 < len(app.variants):
                    res.assignment[app.id] = (app.variants[j + 1], sid)
                    break
        return res
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_failover_plan_reads_not_correct(tmp_path, monkeypatch,
                                                    cell):
    from repro_torch.core.planner import policies
    root = smoke_tree(tmp_path)
    sound = harness.run_cell(cell, 2**31 + 98, 3.0, False, device="cpu",
                             root=root,
                             bench_json=tmp_path / "BENCHMARK.json")
    assert sound["_run"].extra["plan_rounds"] > 0
    assert sound["checks"]["plan_mismatch"]["value"] == 0
    monkeypatch.setattr(policies, "plan_greedy_torch",
                        worse_rung(policies.plan_greedy_torch))
    out = harness.run_cell(cell, 2**31 + 98, 3.0, False, device="cpu",
                           root=root, bench_json=tmp_path / "BENCHMARK.json")
    assert not out["correct"]
    assert out["checks"]["plan_mismatch"]["value"] > 0, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(tmp_path, cell):
    root = smoke_tree(tmp_path, dtype="bfloat16")
    # without crashes every request is served by ``:full`` whatever the
    # threads' timing, so the sample and its readings repeat
    out = harness.run_cell(cell, 2**31 + 5, 3.0, False, device="cpu",
                           root=root, bench_json=tmp_path / "BENCHMARK.json",
                           control=True, fault_schedule=harness.read_json(
                               root / "faults" / "none.json"))
    rows = out["_sample"]
    control = max(r["control_gap"] for r in rows)
    served = max(r["served_gap"] for r in rows)
    gap = out["checks"]["logit_gap"]
    assert not out["correct"]
    assert gap["value"] == control
    assert served <= gap["limit"] < control, (served, gap, control)
    assert torch.finfo(torch.float8_e4m3fn).max == 448.0
