"""The port's training loss and train step against the JAX package's, on
the CPU (part 1 of 2; tests/test_torch_training.py has the rest).

``lm_loss`` (value and gradients) of the port against ``jax.value_and_grad``
of the JAX ``lm_loss`` on bridged SMOKE params and one numpy batch, for
the attention archs (the recurrent archs and whisper are in
test_torch_training.py): llava with ``patch_embeds``, the MoE archs' aux
term, gemma3 with a logit softcap. Loss within 1e-5 relative, each
gradient leaf within 1e-4 x max(1, max|g|) (fp32 through different
operation orders). Also tests/test_archs.py::test_smoke_train_step over
all ten archs on ``device="cpu"``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.lm import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.launch.steps import (batch_to, loss_and_grads,  # noqa: E402
                                      make_train_step)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

B, S = 2, 24          # tests/test_archs.py's batch
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")


def np_batch(cfg, seed=1):
    """tests/test_archs.py's batch keys, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_patch_tokens:
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def check_lm_loss_against_jax(arch, **cfg_kw):
    """The port's lm_loss value, aux and gradients against JAX's on
    bridged SMOKE params (``cfg_kw`` applied to both configs)."""
    cj = jconfigs.get_smoke(arch).replace(**cfg_kw)
    ct = tconfigs.get_smoke(arch).replace(**cfg_kw)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    batch = np_batch(cj)
    (lj, mj), gj = jax.value_and_grad(jax_lm_loss, has_aux=True)(
        pj, cj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt, gt = loss_and_grads(ct, pt, batch_to(batch, CPU))
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    assert abs(float(mt["aux"]) - float(mj["aux"])) <= \
        LOSS_RTOL * max(1.0, abs(float(mj["aux"])))
    assert (float(mt["aux"]) > 0) == bool(cj.num_experts)
    leaves_j = jax.tree_util.tree_leaves(gj)
    leaves_t = tree_leaves(gt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        a = np.asarray(a, np.float32)
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.float().numpy()).max() <= \
            GRAD_RTOL * max(1.0, np.abs(a).max())
    # every leaf the loss reaches has a gradient (none left at zero
    # where JAX's is not)
    for a, b in zip(leaves_j, leaves_t):
        assert bool(np.any(np.asarray(a) != 0)) == bool(torch.any(b != 0))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-32b", "qwen1.5-4b",
                                  "qwen3-moe-30b-a3b", "arctic-480b",
                                  "llava-next-mistral-7b"])
def test_lm_loss_and_grads_match_jax(arch):
    check_lm_loss_against_jax(arch)


def test_lm_loss_and_grads_match_jax_with_softcap():
    """gemma3-27b (local and global layers) with a final-logit softcap:
    the softcap sits before the fp32 cast, as in JAX."""
    check_lm_loss_against_jax("gemma3-27b", logit_softcap=30.0)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_smoke_train_step(arch):
    """tests/test_archs.py::test_smoke_train_step on the port, on the
    CPU: finite loss and grad norm, params moved, a second step finite."""
    cfg = tconfigs.get_smoke(arch)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_state = opt.init(params)
    batch = np_batch(cfg)
    step = make_train_step(cfg, opt)
    params2, opt_state2, metrics = step(params, opt_state, batch)
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(params2)))
    _, _, m2 = step(params2, opt_state2, batch)
    assert torch.isfinite(m2["loss"])
