"""The port's training substrate on the CPU (part 2 of 2, beside
tests/test_torch_trainstep.py): the six tests of tests/test_training.py on
the port, and against the JAX package on the same numpy inputs:

- ``lm_loss`` value and gradients for recurrentgemma-2b, rwkv6-3b and
  whisper-medium (with ``frame_embeds``): 1e-5 relative, 1e-4 x max(1,
  max|g|) a leaf;
- ``chunked_cross_entropy`` (a mask, S not a multiple of the chunk, a
  softcap) and ``cross_entropy``, values and gradients within 1e-5;
- ``AdamW.update`` over both schedules and a bf16 tree (the fp32 master
  copy): params, m, v, master and the grad norm within 1e-6;
- a 5-step qwen2.5-3b SMOKE trajectory, and one with ``microbatches=2``:
  losses within 1e-4 relative;
- checkpoints across the packages, bit-equal, a bf16 leaf included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_trainstep as trainstep  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import checkpoint as JCKPT  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training.data import (DataConfig,  # noqa: E402
                                       SyntheticTokenStream)
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_map  # noqa: E402

CPU = torch.device("cpu")


def _setup(arch="qwen2.5-3b"):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=50)
    return cfg, params, opt


# -- tests/test_training.py on the port ------------------------------------

def test_loss_decreases():
    cfg, params, opt = _setup()
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    data = SyntheticTokenStream(DataConfig(cfg.vocab_size, 4, 32))
    first = last = None
    for _ in range(25):
        params, opt_state, m = step(params, opt_state, data.batch(0))
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first * 0.9, (first, last)


def test_checkpoint_roundtrip(tmp_path):
    cfg, params, opt = _setup()
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    data = SyntheticTokenStream(DataConfig(cfg.vocab_size, 2, 16))
    for i in range(3):
        params, opt_state, _ = step(params, opt_state, data.batch(i))
    CKPT.save_checkpoint(tmp_path, 3, params, opt_state)
    assert CKPT.latest_step(tmp_path) == 3

    tmpl_p = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    tmpl_o = opt.init(tmpl_p)
    step_r, params_r, opt_r, _ = CKPT.restore_checkpoint(
        tmp_path, 3, tmpl_p, tmpl_o, device="cpu")
    assert step_r == 3
    for a, b in zip(tree_leaves(params), tree_leaves(params_r)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves((opt_state.m, opt_state.v)),
                    tree_leaves((opt_r.m, opt_r.v))):
        assert torch.equal(a, b)
    assert int(opt_r.step) == 3
    # training continues identically from the restored state
    _, _, m1 = step(params, opt_state, data.batch(3))
    _, _, m2 = step(params_r, opt_r, data.batch(3))
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)


def test_checkpoint_atomicity(tmp_path):
    cfg, params, opt = _setup()
    CKPT.save_checkpoint(tmp_path, 1, params)
    CKPT.save_checkpoint(tmp_path, 2, params)
    assert CKPT.latest_step(tmp_path) == 2
    # a partially-written (tmp) dir is never visible as a checkpoint
    stray = tmp_path / ".tmp_partial"
    stray.mkdir()
    assert CKPT.latest_step(tmp_path) == 2


def test_data_deterministic_and_seekable():
    d = SyntheticTokenStream(DataConfig(1000, 8, 32, seed=7))
    b1 = d.batch(5)
    b2 = d.batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = d.batch(6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_data_host_sharding_partitions_batch():
    d = SyntheticTokenStream(DataConfig(1000, 8, 16, seed=1))
    full = d.batch(0)
    parts = [d.host_shard(0, i, 4) for i in range(4)]
    glued = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(full["tokens"], glued)


def test_train_driver_resume(tmp_path):
    from repro_torch.launch.train import train
    r1 = train(arch="qwen2.5-3b", scale="toy", steps=6, batch=2, seq=16,
               ckpt_every=3, ckpt_dir=str(tmp_path),
               simulate_failure_at=4, device="cpu")
    assert r1["crashed_at"] == 4
    r2 = train(arch="qwen2.5-3b", scale="toy", steps=6, batch=2, seq=16,
               ckpt_every=3, ckpt_dir=str(tmp_path), resume=True,
               device="cpu")
    assert len(r2["losses"]) == 3      # resumed from step 3


# -- against the JAX package -----------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b",
                                  "whisper-medium"])
def test_lm_loss_and_grads_match_jax(arch):
    trainstep.check_lm_loss_against_jax(arch)


def _ce_inputs(seed, B=2, S=21, d=8, V=37):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((V, d)).astype(np.float32),
            rng.standard_normal((B, S, d)).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32),
            (rng.random((B, S)) < 0.7).astype(np.float32))


@pytest.mark.parametrize("softcap", [0.0, 2.5])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(softcap, masked):
    """S = 21 over chunks of 8 (padded to 24), with and without a mask,
    with and without a softcap: value and d/d(table, x)."""
    table, x, labels, mask = _ce_inputs(11)
    m = mask if masked else None

    def jfn(t, xx):
        return jlm.chunked_cross_entropy(
            t, xx, jnp.asarray(labels),
            None if m is None else jnp.asarray(m), softcap=softcap, chunk=8)

    vj, (gtj, gxj) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt, xt = (torch.from_numpy(a).requires_grad_() for a in (table, x))
    vt = tlm.chunked_cross_entropy(
        tt, xt, torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m), softcap=softcap, chunk=8)
    gtt, gxt = torch.autograd.grad(vt, (tt, xt))
    assert abs(float(vt.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    for a, b in ((gtj, gtt), (gxj, gxt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 9, 31)).astype(np.float32) * 3
    labels = rng.integers(0, 31, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    vj, gj = jax.value_and_grad(lambda lg: jlm.cross_entropy(
        lg, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    vt = tlm.cross_entropy(lt, torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    (gt,) = torch.autograd.grad(vt, (lt,))
    assert abs(float(vt.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "layers": [{"a": (rng.standard_normal((3,)) * scale)
                        .astype(np.float32)},
                       {"a": (rng.standard_normal((2, 4)) * scale)
                        .astype(np.float32)}]}


def _to(tree, dtype):
    """(the JAX tree, the port's tree) of one numpy tree in ``dtype``."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree),
            tree_map(lambda a: torch.from_numpy(a).to(tdt), tree))


def _same(tj, tt, atol):
    lj, lt = jax.tree_util.tree_leaves(tj), tree_leaves(tt)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("schedule,dtype", [("cosine", "float32"),
                                            ("constant", "float32"),
                                            ("cosine", "bfloat16")])
def test_adamw_update_matches_jax(schedule, dtype):
    """Four updates from ``init`` (through the warmup into the decay; the
    first two grads clipped, the last two not): params, m, v, the fp32
    master (bf16 params) and the grad norm within 1e-6."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
              weight_decay=0.1)
    oj, ot = JAdamW(**kw), AdamW(**kw)
    pj, pt = _to(_np_tree(0), dtype)
    sj, st = oj.init(pj), ot.init(pt)
    assert bool(sj.master) == bool(st.master) == (dtype == "bfloat16")
    for i, scale in enumerate((3.0, 1.0, 0.05, 0.01)):
        gj, gt = _to(_np_tree(10 + i, scale), dtype)
        pj, sj, nj = oj.update(gj, sj, pj)
        pt, st, nt = ot.update(gt, st, pt)
        assert abs(float(nt) - float(nj)) <= 1e-6 * max(1.0, float(nj))
        _same(pj, pt, 1e-6)
        _same(sj.m, st.m, 1e-6)
        _same(sj.v, st.v, 1e-6)
        if dtype == "bfloat16":
            _same(sj.master, st.master, 1e-6)
        assert int(st.step) == int(sj.step) == i + 1


def test_adamw_update_leaves_params_and_grads_unwritten():
    opt = AdamW(lr=1e-2, warmup_steps=1)
    _, pt = _to(_np_tree(0), "float32")
    _, gt = _to(_np_tree(1), "float32")
    p0 = tree_map(torch.clone, pt)
    g0 = tree_map(torch.clone, gt)
    new, _, _ = opt.update(gt, opt.init(pt), pt)
    for a, b in zip(tree_leaves(pt), tree_leaves(p0)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(gt), tree_leaves(g0)):
        assert torch.equal(a, b)
    assert all(a is not b for a, b in zip(tree_leaves(new),
                                          tree_leaves(pt)))
    shapes = opt.state_shapes(pt)
    assert all(t.device.type == "meta" for t in tree_leaves(
        (shapes.step, shapes.m, shapes.v)))


def _trajectories(microbatches, steps=5):
    """(JAX losses, port losses) of ``steps`` train steps of qwen2.5-3b
    SMOKE from bridged params on the stream's batches 0.."""
    cj = jconfigs.get_smoke("qwen2.5-3b")
    ct = tconfigs.get_smoke("qwen2.5-3b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    oj, ot = JAdamW(**kw), AdamW(**kw)
    sj, st = oj.init(pj), ot.init(pt)
    step_j = jax.jit(jax_train_step(cj, oj, microbatches=microbatches))
    step_t = make_train_step(ct, ot, microbatches=microbatches)
    data = SyntheticTokenStream(DataConfig(cj.vocab_size, 4, 32))
    lj, lt = [], []
    for i in range(steps):
        b = data.batch(i)
        pj, sj, mj = step_j(pj, sj, b)
        pt, st, mt = step_t(pt, st, b)
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= \
            1e-4 * float(mj["grad_norm"])
    return lj, lt


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_trajectory_matches_jax(microbatches):
    lj, lt = _trajectories(microbatches)
    for a, b in zip(lj, lt):
        assert abs(a - b) <= 1e-4 * abs(a)
    assert lt[-1] < lt[0]


def _mixed_params():
    """A numpy param tree with an fp32 and a bf16 leaf (as fp32 values
    that bf16 holds exactly), and the bf16 leaf's name."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((4, 6)).astype(np.float32)
    h = np.asarray(jnp.asarray(h, jnp.bfloat16), np.float32)
    return {"embed": {"table": rng.standard_normal((9, 4))
                      .astype(np.float32)},
            "cycles": [{"h": h}]}


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _jax_tree(np_tree):
    return {"embed": {"table": jnp.asarray(np_tree["embed"]["table"])},
            "cycles": [{"h": jnp.asarray(np_tree["cycles"][0]["h"],
                                         jnp.bfloat16)}]}


def _port_tree(np_tree):
    return {"embed": {"table": torch.from_numpy(np_tree["embed"]["table"])},
            "cycles": [{"h": torch.from_numpy(np_tree["cycles"][0]["h"])
                        .to(torch.bfloat16)}]}


def _assert_bit_equal(a, b):
    """Two trees (of JAX arrays or tensors) leaf by leaf, bit for bit;
    both helpers visit dict keys sorted."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX checkpoint (params with a bf16 leaf, AdamW state with its
    fp32 master) restores in the port bit for bit; the port reads the
    bf16 leaf's raw words, which JAX's own restore cannot cast (R10)."""
    np_tree = _mixed_params()
    pj = _jax_tree(np_tree)
    oj = JAdamW()
    sj = oj.init(pj)
    sj = sj._replace(step=jnp.asarray(5, jnp.int32),
                     m=jax.tree_util.tree_map(lambda x: x + 0.25, sj.m))
    JCKPT.save_checkpoint(tmp_path, 5, pj, sj)
    tmpl = _port_tree(np_tree)
    ot = AdamW()
    step, pt, st, _ = CKPT.restore_checkpoint(tmp_path, 5, tmpl,
                                              ot.state_shapes(tmpl),
                                              device="cpu")
    assert step == 5 and int(st.step) == 5
    assert pt["cycles"][0]["h"].dtype == torch.bfloat16
    _assert_bit_equal(pj, pt)
    _assert_bit_equal((sj.m, sj.v, sj.master), (st.m, st.v, st.master))
    with pytest.raises(ValueError):      # R10: the reference's own restore
        JCKPT.restore_checkpoint(tmp_path, 5, pj, sj)


def test_port_checkpoint_restores_in_jax(tmp_path):
    np_tree = _mixed_params()
    pt = _port_tree(np_tree)
    ot = AdamW()
    st = ot.init(pt)
    st = st._replace(step=torch.tensor(9, dtype=torch.int32),
                     v=tree_map(lambda x: x + 0.5, st.v))
    CKPT.save_checkpoint(tmp_path, 9, pt, st, extra={"note": "port"})
    pj = _jax_tree(np_tree)
    oj = JAdamW()
    step, pr, sr, extra = JCKPT.restore_checkpoint(tmp_path, 9, pj,
                                                   oj.init(pj))
    assert step == 9 and int(sr.step) == 9 and extra == {"note": "port"}
    assert pr["cycles"][0]["h"].dtype == jnp.bfloat16
    _assert_bit_equal(pr, pt)
    _assert_bit_equal((sr.m, sr.v, sr.master), (st.m, st.v, st.master))
