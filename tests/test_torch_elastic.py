"""Elastic restore on the port (``restore_checkpoint(..., shardings=,
opt_shardings=)``), the port of tests/test_elastic.py.

The JAX package's ``save_checkpoint`` writes a SMOKE qwen2.5-3b's params
and AdamW state; the port restores them as DTensors laid out by its
sharding rules, in a fresh process each (a process group is process
state):

- onto a (2, 4) ``DeviceMesh`` of a fake process group, as rank 0: each
  leaf's local shard is the leading block of the saved array, of JAX's
  ``shard_shape`` on a (2, 4) mesh, bit for bit;
- onto the (1, 1) local mesh (gloo, the CPU): every leaf bit-equal, whole
  through ``local_tree`` and through ``bridge.params_to_numpy``; and the
  training driver's resume through the same restore.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.training import checkpoint as JCKPT  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_RESTORE = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge, configs
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import model as MDL
from repro_torch.parallel import sharding as SH
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.optimizer import AdamW, state_shardings
from torch.distributed.tensor import DTensor

ckpt, out, kind = sys.argv[1:4]
if kind == "fake":
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
else:
    mesh = make_local_mesh(device="cpu")
cfg = configs.get_smoke("qwen2.5-3b")
tmpl_p = MDL.param_shapes(cfg)
opt = AdamW()
tmpl_o = opt.state_shapes(tmpl_p)
step, params, opt_state, _ = CKPT.restore_checkpoint(
    ckpt, 7, tmpl_p, tmpl_o, shardings=SH.param_shardings(tmpl_p, mesh),
    opt_shardings=state_shardings(tmpl_o, mesh))
assert step == 7
leaves = {}
for root, tree in (("params", params), ("opt", opt_state)):
    for path, leaf in CKPT._flatten(tree, root):
        assert isinstance(leaf, DTensor), path
        assert leaf.device_mesh is mesh, path
        leaves[path] = leaf.to_local().numpy()
if kind == "local":
    local = CKPT.local_tree(params)
    whole = bridge.params_to_numpy(params)
    for (path, a), (_, b) in zip(CKPT._flatten(local, "params"),
                                 CKPT._flatten(whole, "params")):
        assert type(a) is torch.Tensor, path
        assert np.array_equal(a.numpy(), b), path
    assert isinstance(CKPT.local_tree(opt_state).step, torch.Tensor)
    from repro_torch.launch.train import train
    kw = dict(arch="qwen2.5-3b", scale="toy", steps=6, batch=2, seq=16,
              ckpt_every=2, ckpt_dir=out + "_ckpt", device="cpu")
    crashed = train(**kw, simulate_failure_at=3)
    resumed = train(**kw, resume=True, mesh=mesh)
    whole = train(**{**kw, "ckpt_dir": out + "_whole"})
    assert crashed["crashed_at"] == 3 and len(resumed["losses"]) == 4
    assert resumed["losses"] == whole["losses"][2:]
else:
    from repro_torch.launch.train import train
    try:
        train(arch="qwen2.5-3b", scale="toy", steps=1, device="cpu",
              mesh=mesh)
        raise AssertionError("train() took an 8-rank mesh")
    except ValueError:
        pass
np.savez(out, **{p.replace("/", "__"): v for p, v in leaves.items()})
print("RESTORED", len(leaves))
"""


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A SMOKE qwen2.5-3b checkpoint the JAX package wrote at step 7, and
    its params and AdamW state as numpy by tree path."""
    d = tmp_path_factory.mktemp("elastic")
    cfg = jconfigs.get_smoke("qwen2.5-3b")
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    opt = JAdamW()
    state = opt.init(params)
    # a state that is not all zeros: one update's moments
    grads = jax.tree_util.tree_map(lambda p: p * 0.5 + 0.25, params)
    params, state, _ = opt.update(grads, state, params)
    JCKPT.save_checkpoint(d, 7, params, state)
    want = {p: np.asarray(v) for p, v in JCKPT._flatten(params, "params")}
    want.update({p: np.asarray(v) for p, v in JCKPT._flatten(state, "opt")})
    return d, want, params, state


def _restore(ckpt, tmp_path, kind):
    out = str(tmp_path / f"{kind}.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _RESTORE, str(ckpt), out,
                          kind], env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESTORED" in res.stdout
    with np.load(out) as z:
        return {k.replace("__", "/"): z[k] for k in z.files}


def _jax_shardings(params, state, mesh):
    """JAX's shardings of each saved leaf, by tree path (m/v like the
    params, the step replicated, as the JAX dry run lays the state out)."""
    out = {}
    for root, tree in (("params", params), ("opt/m", state.m),
                       ("opt/v", state.v)):
        sh = JSH.param_shardings(tree, mesh)
        for (p, _), (_, s) in zip(JCKPT._flatten(tree, root),
                                  JCKPT._flatten(sh, root)):
            out[p] = s
    return out


def test_restore_onto_a_fake_2x4_mesh(saved, tmp_path):
    """Rank 0 of 8 on a (2, 4) mesh holds the leading block of each saved
    leaf, of JAX's shard shape, bit for bit; ``train(..., mesh=)`` refuses
    a mesh of more than one rank."""
    ckpt, want, params, state = saved
    got = _restore(ckpt, tmp_path, "fake")
    assert set(got) == set(want)
    shs = _jax_shardings(params, state,
                         JAbstractMesh((2, 4), ("data", "model")))
    split = 0
    for path, arr in want.items():
        sh = shs.get(path)
        shape = (arr.shape if sh is None else
                 tuple(sh.shard_shape(arr.shape)))
        assert isinstance(sh, (JNamedSharding, type(None)))
        assert got[path].shape == shape, path
        block = arr[tuple(slice(0, n) for n in shape)]
        assert np.array_equal(got[path], block), path
        split += shape != arr.shape
    assert split > 0


def test_restore_onto_the_local_mesh_is_bit_equal(saved, tmp_path):
    """The (1, 1) mesh: every leaf whole and bit-equal; ``local_tree`` and
    ``params_to_numpy`` give the same arrays; ``train(..., mesh=)`` resumes
    through the sharded restore with the uninterrupted run's losses."""
    ckpt, want, _, _ = saved
    got = _restore(ckpt, tmp_path, "local")
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        assert np.array_equal(got[path], arr), path
