"""``cfg.remat`` in the port (``models/model.py`` ``remat_regions``,
``models/encdec.py``) against the JAX package's ``jax.checkpoint(...,
nothing_saveable)``, on the CPU.

With ``remat=True`` on bridged SMOKE params the port's ``lm_loss`` and its
gradients match ``jax.value_and_grad`` of the JAX ``lm_loss`` at
tests/test_torch_trainstep.py's tolerances; the port's gradients with
remat are bit-equal to its own without (MoE archs within 1e-4 x max(1,
max|g|), since the MoE dispatch's ``index_add_`` need not repeat its bits
on the card); a recorded forward enters as many checkpoint regions as the
JAX forward's jaxpr holds (a layer each on gemma3's merged route, a
``block_pattern`` cycle each elsewhere, none for tail layers); the
activations kept for the backward shrink; no checkpoint is entered when
autograd does not record; the recompute reads a swapped dispatcher at
backward time; and the dry run's ``temp_bytes`` of a train cell falls.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_trainstep as trainstep  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.steps import batch_to, loss_and_grads  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.lm import lm_loss  # noqa: E402
from repro_torch.training.tree import (tree_leaves,  # noqa: E402
                                       tree_unflatten)

CPU = torch.device("cpu")
# one SMOKE arch per loop kind; gemma3-27b twice: its SMOKE window of 8
# binds at S=24 (the cycle route, two local tail layers), a window of 32
# does not (JAX's merged per-layer scan, the tail included)
CASES = {
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "gemma3-27b": ("gemma3-27b", {}),
    "gemma3-27b-merged": ("gemma3-27b", {"window_size": 32}),
    "rwkv6-3b": ("rwkv6-3b", {}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "whisper-medium": ("whisper-medium", {}),
}
JAX_CASES = ("qwen2.5-3b", "recurrentgemma-2b", "gemma3-27b-merged",
             "rwkv6-3b", "qwen3-moe-30b-a3b", "whisper-medium")
REMAT_PRIMITIVES = ("checkpoint", "remat", "remat2")


def _setup(case, remat):
    arch, kw = CASES[case]
    cfg = tconfigs.get_smoke(arch).replace(remat=remat, **kw)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    return cfg, params, batch_to(trainstep.np_batch(cfg), CPU)


class _Regions:
    """A stand-in for the model's ``checkpoint`` that counts the regions
    it runs and calls the real one."""

    def __init__(self, real):
        self.real, self.n = real, 0

    def __call__(self, fn, *args, **kw):
        self.n += 1
        return self.real(fn, *args, **kw)


@pytest.fixture
def regions(monkeypatch):
    counter = _Regions(TM.checkpoint)
    monkeypatch.setattr(TM, "checkpoint", counter)
    return counter


@pytest.mark.parametrize("case", JAX_CASES)
def test_lm_loss_and_grads_match_jax_with_remat(case):
    """The port's loss, aux and every gradient leaf against JAX's
    ``remat=True`` ``value_and_grad`` on bridged params."""
    arch, kw = CASES[case]
    trainstep.check_lm_loss_against_jax(arch, remat=True, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_gradients_equal_no_remat(case, regions):
    """The same loss and gradients with and without remat: bit for bit,
    MoE archs within 1e-4 x max(1, max|g|); only the remat run enters
    checkpoint regions."""
    cfg, params, batch = _setup(case, False)
    l0, _, g0 = loss_and_grads(cfg, params, batch)
    assert regions.n == 0
    l1, _, g1 = loss_and_grads(cfg.replace(remat=True), params, batch)
    assert regions.n > 0
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        if cfg.num_experts:
            assert float((a - b).abs().max()) <= \
                trainstep.GRAD_RTOL * max(1.0, float(a.abs().max()))
        else:
            assert torch.equal(a, b)


def _jax_regions(jaxpr, d_model):
    """The model-level remat regions a forward's jaxpr runs: checkpoint
    equations whose outputs hold the residual stream (rank 3, last dim
    ``d_model``; flash attention's per-block checkpoints carry rank-4
    tiles), each counted as many times as the scans around it run."""
    n = 0
    for e in jaxpr.eqns:
        if e.primitive.name in REMAT_PRIMITIVES:
            n += any(len(v.aval.shape) == 3 and v.aval.shape[-1] == d_model
                     for v in e.outvars)
            continue
        times = e.params["length"] if e.primitive.name == "scan" else 1
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += times * _jax_regions(sub, d_model)
    return n


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_regions_match_jax(case, regions):
    """A recorded forward enters as many regions as the JAX forward
    checkpoints, grouped as JAX groups them: a layer each on the merged
    route, else a cycle each with every tail layer outside."""
    cfg, params, batch = _setup(case, True)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    lm_loss(tree_unflatten(params, leaves), cfg, batch)
    arch, kw = CASES[case]
    cj = jconfigs.get_smoke(arch).replace(remat=True, **kw)
    pj = JM.param_shapes(cj)
    toks = jnp.asarray(batch["tokens"].numpy())
    frames = (jnp.asarray(batch["frame_embeds"].numpy())
              if cfg.is_encoder_decoder else None)
    jx = jax.make_jaxpr(
        lambda p: JM.forward_features(p, cj, toks, frames))(pj)
    want = _jax_regions(jx.jaxpr, cfg.d_model)
    assert regions.n == want > 0
    if cfg.is_encoder_decoder:
        assert want == cfg.num_encoder_layers + cfg.num_decoder_layers
        return
    groups = TM.remat_regions(cfg, params, batch["tokens"].shape[1])
    assert sum(len(g) for g, _ in groups) == cfg.num_layers
    if case == "gemma3-27b-merged":
        assert all(len(g) == 1 and region for g, region in groups)
        return
    n_tail = len(params["tail"])
    body, tail = groups[:len(groups) - n_tail], groups[len(groups) - n_tail:]
    assert all(region and tuple(k for k, _ in g) == cfg.block_pattern
               for g, region in body)
    assert all(len(g) == 1 and not region for g, region in tail)


def _saved_activation_bytes(cfg, params, batch):
    """Bytes of the storages autograd saves in one ``lm_loss`` forward
    outside every checkpoint region (a region's own hooks take its
    tensors), less those sharing storage with a param leaf."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    param_storage = {t.untyped_storage().data_ptr() for t in leaves}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in param_storage:
            saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lm_loss(tree_unflatten(params, leaves), cfg, batch)
    return sum(saved.values())


@pytest.mark.parametrize("case", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_saved_activations_fall(case, regions):
    """The bytes kept for the backward fall with remat, even counting
    each region's input, which the checkpoint holds to recompute from."""
    cfg, params, batch = _setup(case, False)
    without = _saved_activation_bytes(cfg, params, batch)
    with_remat = _saved_activation_bytes(cfg.replace(remat=True), params,
                                         batch)
    widest = max(batch["tokens"].numel(),
                 batch.get("frame_embeds", batch["tokens"]).shape[:2].numel())
    inputs = regions.n * widest * cfg.d_model * 4
    assert 0 < with_remat + inputs < without / 2


def test_no_checkpoint_without_grad(regions):
    """No region under ``no_grad``, ``inference_mode`` or with nothing
    requiring grad; the outputs are the no-remat forward's."""
    for case in ("recurrentgemma-2b", "whisper-medium"):
        cfg, params, batch = _setup(case, True)
        args = (batch["tokens"], batch.get("frame_embeds"))
        want, _ = TM.forward(params, cfg.replace(remat=False), *args)
        with torch.no_grad():
            a, _ = TM.forward(params, cfg, *args)
        with torch.inference_mode():
            b, _ = TM.forward(params, cfg, *args)
            cache = TM.init_cache(cfg, 2, 32, device="cpu")
            TM.prefill(params, cfg, batch["tokens"][:, :8], cache, args[1])
            TM.decode_step(params, cfg, batch["tokens"][:, 8], cache)
        c, _ = TM.forward(params, cfg, *args)
        assert regions.n == 0
        for got in (a, b, c):
            assert torch.equal(got, want)


def test_recompute_reads_the_route_at_backward_time(regions):
    """A non-reentrant checkpoint recomputes inside ``backward()``, so a
    dispatcher swapped for the forward (chip_smoke's ``plain_attention``)
    must still be in place when the backward runs: inside, the swapped
    route sees every attention layer twice; a backward after the swap is
    undone recomputes through the original route."""
    cfg, params, batch = _setup("qwen2.5-3b", True)
    calls = []
    real = TL.flash_attention

    def swapped(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for backward_inside in (True, False):
        calls.clear()
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        TL.flash_attention = swapped
        try:
            loss, _ = lm_loss(tree_unflatten(params, leaves), cfg, batch)
            if backward_inside:
                torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            TL.flash_attention = real
        if not backward_inside:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        assert len(calls) == cfg.num_layers * (2 if backward_inside else 1)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_dry_run_temp_bytes_fall_with_remat(arch):
    """``lower_cell`` on a small train cell: lower ``temp_bytes`` with
    remat, and more FLOPs (the recomputed forward is counted, as XLA
    counts a remat'd HLO's)."""
    cell = ShapeCell("smoke_train", "train", 64, 4)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    recs = [TD.lower_cell(arch, cell, mesh, cfg_override=tconfigs.get_smoke(
        arch).replace(remat=remat)) for remat in (False, True)]
    (m0, c0), (m1, c1) = ((r["memory"], r["cost"]) for r in recs)
    assert 0 < m1["temp_bytes"] < m0["temp_bytes"]
    assert m1["argument_bytes"] == m0["argument_bytes"]
    assert c1["global_flops"] > c0["global_flops"]
    assert np.isfinite(recs[1]["roofline"]["useful_flop_frac"])
