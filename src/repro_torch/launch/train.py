"""End-to-end training driver (port of ``repro/launch/train.py``).

Trains an LM (default: a ~100M-param qwen2.5-family config) for a few
hundred steps on the card (or the CPU with ``device="cpu"``), with the
fault-tolerance path wired in: periodic checkpoints, automatic restart
from the latest checkpoint (bit-identical data order via the seekable
pipeline), and a per-step straggler deadline that logs pathological
steps. The printed lines are the JAX driver's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 300 \\
      --arch qwen2.5-3b --scale 100m [--resume] [--simulate-failure-at 150] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch import configs
from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.launch.mesh import mesh_name
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.parallel import sharding as SH
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import DataConfig, SyntheticTokenStream
from repro_torch.training.optimizer import AdamW, state_shardings


def scale_config(cfg, scale: str):
    """Shrink an assigned arch config to a target param budget."""
    presets = {
        "100m": dict(num_layers=8, d_model=512, num_heads=8,
                     num_kv_heads=2, head_dim=64, d_ff=2048,
                     vocab_size=32_000),
        "20m": dict(num_layers=4, d_model=256, num_heads=4,
                    num_kv_heads=2, head_dim=64, d_ff=1024,
                    vocab_size=16_000),
        "toy": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=503),
    }
    kw = dict(presets[scale])
    kw.update(param_dtype="float32", activation_dtype="float32",
              remat=False, tie_embeddings=True)
    if cfg.num_experts:
        kw.update(num_experts=8, top_k=2, moe_d_ff=kw["d_ff"] // 4)
    if cfg.rnn_width:
        kw.update(rnn_width=kw["d_model"], rnn_blocks=4)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=kw["num_layers"] // 2,
                  num_decoder_layers=kw["num_layers"] // 2,
                  encoder_seq_len=64)
    return cfg.replace(**kw)


def train(arch: str = "qwen2.5-3b", scale: str = "100m", steps: int = 300,
          batch: int = 8, seq: int = 256, ckpt_every: int = 50,
          ckpt_dir: str = "checkpoints", resume: bool = False,
          straggler_deadline_s: float = 300.0,
          simulate_failure_at: int = -1, log_every: int = 10,
          seed: int = 0, device: DeviceLike = None, mesh=None):
    """Train; ``mesh`` (a one-rank ``DeviceMesh`` on ``device``) makes a
    resume the elastic restore: the checkpoint comes back through
    ``shardings=`` (params and AdamW state in ``param_shardings``' layout
    on the mesh) and the steps take its local shards."""
    dev = resolve_device(device)
    cfg = scale_config(configs.get_config(arch), scale)
    print(f"arch={arch} scale={scale}: {cfg.param_count()/1e6:.1f}M params")

    opt = AdamW(lr=3e-4, warmup_steps=max(10, steps // 20),
                total_steps=steps)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticTokenStream(DataConfig(cfg.vocab_size, batch, seq,
                                           seed=seed))
    ckpt_path = Path(ckpt_dir) / f"{arch}-{scale}"

    start = 0
    params = opt_state = None
    if mesh is not None and mesh.size() > 1:
        raise ValueError(f"train() steps on one device; mesh "
                         f"{mesh_name(mesh)} has {mesh.size()} ranks")
    if resume and (last := CKPT.latest_step(ckpt_path)) is not None:
        tmpl_p = MDL.param_shapes(cfg)
        tmpl_o = opt.state_shapes(tmpl_p)
        start, params, opt_state, _ = CKPT.restore_checkpoint(
            ckpt_path, last, tmpl_p, tmpl_o, device=dev,
            shardings=(SH.param_shardings(tmpl_p, mesh)
                       if mesh is not None else None),
            opt_shardings=(state_shardings(tmpl_o, mesh)
                           if mesh is not None else None))
        params, opt_state = (CKPT.local_tree(params),
                             CKPT.local_tree(opt_state))
        print(f"resumed from step {start}"
              + (f" onto mesh {mesh_name(mesh)}" if mesh is not None
                 else ""))
    if params is None:
        params = MDL.init_params(generator_for(dev, seed), cfg, device=dev)
        opt_state = opt.init(params)

    losses = []
    t_start = time.time()
    for step in range(start, steps):
        if step == simulate_failure_at:
            print(f"[fault-injection] simulated crash at step {step}; "
                  f"restart with --resume to continue from "
                  f"step {CKPT.latest_step(ckpt_path)}")
            return {"crashed_at": step, "losses": losses}
        t0 = time.time()
        b = data.batch(step, cfg)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if dt > straggler_deadline_s:
            print(f"[straggler] step {step} took {dt:.1f}s "
                  f"(deadline {straggler_deadline_s}s)")
        losses.append(loss)
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if ckpt_every and (step + 1) % ckpt_every == 0:
            CKPT.save_checkpoint(ckpt_path, step + 1, params, opt_state)

    wall = time.time() - t_start
    print(f"done: {steps - start} steps in {wall:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "wall_s": wall,
            "final_loss": losses[-1] if losses else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--scale", default="100m",
                    choices=["100m", "20m", "toy"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the model trains (default: the CUDA card)")
    a = ap.parse_args(argv)
    train(a.arch, a.scale, a.steps, a.batch, a.seq, a.ckpt_every,
          a.ckpt_dir, a.resume, simulate_failure_at=a.simulate_failure_at,
          seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
