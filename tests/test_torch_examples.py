"""The example ports (``examples/*_torch.py``) on the CPU, against the
JAX package's examples beside them.

Each simulator example with ``--device cpu`` prints what the JAX example
prints for the same spec and seed, line for line (recovery records,
modes, MTTRs, traffic); ``edge_failover_torch.py`` does on the ``sim``
backend and recovers every app on the live testbed; ``train_lm_torch.py
--scale toy`` crashes, resumes, and ends on an uninterrupted run's loss;
no example port imports ``jax`` or ``repro``, and without a card and
``--device cpu`` each raises as ``resolve_device`` does.
"""

import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTS = ("quickstart", "failure_storm", "site_failure_sim", "edge_failover",
         "train_lm")
SIM_EXAMPLES = ("quickstart", "failure_storm", "site_failure_sim")


def _load(name):
    """The example file ``name``.py as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(*args)
    return out.getvalue()


@pytest.mark.parametrize("name", SIM_EXAMPLES)
def test_sim_example_prints_the_jax_examples_records(name):
    port = _stdout(_load(f"{name}_torch").main, ["--device", "cpu"])
    assert "recover" in port
    assert port == _stdout(_load(name).main)


def test_edge_failover_example(monkeypatch):
    """On the sim backend the JAX example's lines; on the live testbed
    (CPU engines, a short settle) the one app that lost its primary
    recovers and every client was served."""
    port = _load("edge_failover_torch")
    sim = _stdout(port.main, ["--backend", "sim", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["edge_failover.py", "--backend", "sim"])
    assert sim == _stdout(_load("edge_failover").main)
    live = _stdout(port.main, ["--device", "cpu", "--settle", "2"])
    assert "recovery: 100%" in live
    assert "detected in" in live
    assert " ok=   0 " not in live


def test_train_lm_example_resumes_to_the_uninterrupted_loss(monkeypatch,
                                                            tmp_path):
    """``--scale toy``: phase 1 crashes at half the steps, phase 2 resumes
    from the last checkpoint, and its losses are the tail of one
    uninterrupted run's, bit for bit. One intra-op thread: the CPU's
    threaded reductions vary in the last bits between runs (ROADMAP
    P14); on the card the kernels repeat their bits."""
    port = _load("train_lm_torch")
    runs = []

    def recorded(**kw):
        runs.append(port_train(**kw))
        return runs[-1]

    port_train = port.train
    monkeypatch.setattr(port, "train", recorded)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _stdout(port.main, ["--scale", "toy", "--steps", "50",
                                  "--device", "cpu"])
        whole = port_train(arch="qwen2.5-3b", scale="toy", steps=50,
                           batch=8, seq=128, ckpt_every=0,
                           ckpt_dir=str(tmp_path), device="cpu")
    finally:
        torch.set_num_threads(threads)
    crashed, resumed = runs
    assert crashed["crashed_at"] == 25
    assert crashed["losses"] == whole["losses"][:25]
    assert resumed["losses"] == whole["losses"][25:]
    assert resumed["final_loss"] == whole["final_loss"]
    assert f"final loss: {whole['final_loss']:.4f}" in out


def _imports(path):
    """The top-level package of every import in ``path``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module.split(".")[0]


def test_example_ports_import_neither_jax_nor_repro():
    """No import of ``jax`` or ``repro`` in the five files; importing each
    and running the quickstart and the edge failover's sim backend in a
    fresh process loads neither."""
    for name in PORTS:
        mods = set(_imports(EXAMPLES / f"{name}_torch.py"))
        assert "repro_torch" in mods and not mods & {"jax", "repro"}, name
    code = (
        "import importlib.util, sys\n"
        "mods = {}\n"
        f"for n in {PORTS!r}:\n"
        "    s = importlib.util.spec_from_file_location(n, "
        f"{str(EXAMPLES)!r} + '/' + n + '_torch.py')\n"
        "    mods[n] = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(mods[n])\n"
        "mods['quickstart'].main(['--device', 'cpu'])\n"
        "mods['edge_failover'].main(['--backend', 'sim', '--device', "
        "'cpu'])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("name", PORTS)
def test_example_port_raises_without_a_card(name, monkeypatch):
    """With no card and no ``--device cpu`` each example fails as
    ``resolve_device`` does, never running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--scale", "toy", "--steps", "2"] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no.*CUDA|CUDA device"):
        _stdout(_load(f"{name}_torch").main, args)
