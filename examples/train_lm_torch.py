"""Train a ~100M-parameter LM on the PyTorch port for a few hundred steps
with the full fault-tolerance path (examples/train_lm.py through
``repro_torch.launch.train``): periodic checkpoints, a simulated crash,
and an automatic restart that resumes bit-identically. Trains on the
CUDA card, or on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", default="20m", choices=["toy", "20m", "100m"])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the model trains (default: the CUDA card)")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="faillite_train_")
    crash_at = args.steps // 2
    print(f"=== phase 1: train to step {crash_at}, then crash ===")
    train(arch="qwen2.5-3b", scale=args.scale, steps=args.steps,
          batch=8, seq=128, ckpt_every=25, ckpt_dir=ckpt,
          simulate_failure_at=crash_at, device=args.device)

    print("\n=== phase 2: elastic restart from the latest checkpoint ===")
    out = train(arch="qwen2.5-3b", scale=args.scale, steps=args.steps,
                batch=8, seq=128, ckpt_every=25, ckpt_dir=ckpt,
                resume=True, device=args.device)
    print(f"\nfinal loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
