"""The port's copies of the control-plane modules against the originals,
the port's import boundary, and its device rule."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import heartbeat as jhb  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import heartbeat as thb  # noqa: E402
from repro_torch.core import variants as tvariants  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG_FIELDS = ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "quant_bits", "width_mult",
              "depth_mult", "param_dtype", "activation_dtype", "rnn_width",
              "rnn_blocks", "window_size", "rwkv_head_size", "block_pattern",
              "tie_embeddings", "scale_embedding")
ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b"]


def test_configs_are_copies():
    for arch in ARCHS:
        for getter in ("get_config", "get_smoke"):
            a = getattr(jconfigs, getter)(arch)
            b = getattr(tconfigs, getter)(arch)
            fa = {f: getattr(a, f) for f in a.__dataclass_fields__}
            fb = {f: getattr(b, f) for f in b.__dataclass_fields__}
            assert fa == fb, (arch, getter)


@pytest.mark.parametrize("arch", ARCHS[1:])
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_build_ladder_matches_jax_recurrent(which, arch):
    test_build_ladder_matches_jax(which, arch)


def test_recurrentgemma_full_rung_has_27_layers():
    """The ladder rounds depth to whole (rglru, rglru, local) cycles, so
    the served :full has 27 layers where the published config has 26."""
    for mod in (jvariants, tvariants):
        cfgs = jconfigs if mod is jvariants else tconfigs
        ladder = mod.build_ladder(cfgs.get_config("recurrentgemma-2b"))
        full = ladder[0]
        assert full.name == "recurrentgemma-2b:full"
        assert full.config.num_layers == 27
        assert cfgs.get_config("recurrentgemma-2b").num_layers == 26


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_build_ladder_matches_jax(which, arch="qwen2.5-3b"):
    get_j = jconfigs.get_config if which == "CONFIG" else jconfigs.get_smoke
    get_t = tconfigs.get_config if which == "CONFIG" else tconfigs.get_smoke
    lj = jvariants.build_ladder(get_j(arch))
    lt = tvariants.build_ladder(get_t(arch))
    assert [v.name for v in lj] == [v.name for v in lt]
    for a, b in zip(lj, lt):
        assert (a.mem_bytes, a.compute, a.accuracy, a.quant_bits,
                a.width_mult, a.depth_mult) == \
               (b.mem_bytes, b.compute, b.accuracy, b.quant_bits,
                b.width_mult, b.depth_mult)
        for f in CFG_FIELDS:
            assert getattr(a.config, f) == getattr(b.config, f), f
        assert a.config.param_count() == b.config.param_count()
    assert tvariants.LADDER_STEPS == jvariants.LADDER_STEPS


def test_application_picks_variants_like_jax():
    lj = jvariants.build_ladder(jconfigs.get_config("qwen2.5-3b"))
    lt = tvariants.build_ladder(tconfigs.get_config("qwen2.5-3b"))
    aj = jvariants.Application(id="a", family="qwen2.5-3b", variants=lj)
    at = tvariants.Application(id="a", family="qwen2.5-3b", variants=lt)
    assert (aj.full.name, aj.smallest.name) == (at.full.name, at.smallest.name)
    assert (aj.demand_matrix() == at.demand_matrix()).all()


def test_failure_detector_matches_jax():
    """Same beats and sweeps on a simulated clock -> same detections."""
    script = [("beat", "s1"), ("beat", "s2"), ("adv", 0.03),
              ("beat", "s1"), ("adv", 0.015), ("sweep",), ("adv", 0.03),
              ("sweep",), ("sweep",), ("mark", "s1"), ("revive", "s2"),
              ("adv", 0.05), ("sweep",), ("dereg", "s2"), ("beat", "s3"),
              ("adv", 1.0), ("sweep",)]
    results = []
    for mod in (jhb, thb):
        clock = mod.SimClock()
        det = mod.FailureDetector(clock, interval=0.020, miss_count=2)
        seen = []
        for op in script:
            if op[0] == "beat":
                det.beat(op[1])
            elif op[0] == "adv":
                clock.advance(op[1])
            elif op[0] == "sweep":
                seen.append(sorted(det.sweep()))
            elif op[0] == "mark":
                det.mark_failed(op[1])
            elif op[0] == "revive":
                det.revive(op[1])
            elif op[0] == "dereg":
                det.deregister(op[1])
        seen.append(sorted(det.failed))
        seen.append(det.detection_latency_bound())
        results.append(seen)
    assert results[0] == results[1]
    assert results[1][:3] == [["s2"], ["s1"], []]


def test_router_epoch_and_push():
    r = Router()
    seen = []
    r.subscribe(lambda a, s, v: seen.append((a, s, v)))
    r.set_route("app1", "s1", "m:full")
    assert r.lookup("app1") == ("s1", "m:full")
    e0 = r.epoch
    r.set_route("app1", "s2", "m:w050")
    assert r.epoch == e0 + 1
    assert seen[-1] == ("app1", "s2", "m:w050")
    r.set_backup("app1", "s3", "m:w025")
    assert r.lookup_backup("app1") == ("s3", "m:w025")
    assert r.epoch == e0 + 1                  # backups do not bump
    assert r.drop_route("app1") == e0 + 2
    assert seen[-1] == ("app1", None, None)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('repro_torch')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 45
    assert {"repro_torch.models.rglru", "repro_torch.models.rwkv6",
            "repro_torch.kernels.rglru_scan.ops",
            "repro_torch.kernels.rwkv6_scan.ops",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.rwkv6_3b"} <= mods
    assert {f"repro_torch.core.{m}" for m in PLANNING_COPIES + (
        "controller", "simulation", "planner.kernels",
        "planner.torch_backend", "planner.policies")} <= mods
    assert {"repro_torch.kernels.planner_argmax.ops",
            "repro_torch.kernels.planner_argmax.ref"} <= mods


# control-plane modules of the simulator's planning path that the port
# copies verbatim (only the imports name repro_torch)
PLANNING_COPIES = ("cluster", "planner.base", "planner.state",
                   "planner.vectorized", "datastore", "modelstate",
                   "metrics", "resilience", "traffic", "scenario", "chaos")


@pytest.mark.parametrize("mod", PLANNING_COPIES)
def test_planning_modules_are_verbatim_copies(mod):
    """Each copy equals its original once ``repro_torch`` reads
    ``repro``: a change to either side shows here."""
    rel = Path(*mod.split(".")).with_suffix(".py")
    orig = (ROOT / "src" / "repro" / "core" / rel).read_text()
    copy = (ROOT / "src" / "repro_torch" / "core" / rel).read_text()
    assert copy.replace("repro_torch", "repro") == orig


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")
    from repro_torch.device import generator_for, resolve_device
    from repro_torch.models import model as MDL
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.server import WorkerServer
    cfg = tconfigs.get_smoke("qwen2.5-3b")
    cpu = torch.device("cpu")
    det = thb.FailureDetector(thb.WallClock())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MDL.init_params(generator_for(cpu, 0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        MDL.init_cache(cfg, 1, 8)
    params = MDL.init_params(generator_for(cpu, 0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerServer("w", det)
    assert resolve_device("cpu") == cpu


def test_unported_archs_and_kinds_raise():
    for arch in ("qwen3-32b", "qwen3-moe-30b-a3b", "gemma3-27b"):
        with pytest.raises(KeyError, match="ROADMAP"):
            tconfigs.get_config(arch)
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("nope")
    assert set(ARCHS) <= set(tconfigs.ARCHS)
    from repro_torch.models import model as MDL
    from repro_torch.device import generator_for
    cfg = tconfigs.get_smoke("qwen2.5-3b")
    gen = generator_for(torch.device("cpu"), 0)
    for bad in (cfg.replace(block_pattern=("moe",), num_experts=4, top_k=2),
                cfg.replace(block_pattern=("global", "moe_dense")),
                cfg.replace(qk_norm=True),
                cfg.replace(is_encoder_decoder=True),
                cfg.replace(num_patch_tokens=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MDL.init_params(gen, bad, device="cpu")
    # the kinds and features this slice brought now build
    for good in (cfg.replace(block_pattern=("local", "global")),
                 cfg.replace(tie_embeddings=False)):
        MDL.init_params(gen, good, device="cpu")
