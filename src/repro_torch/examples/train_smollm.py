"""End-to-end training example: train a (reduced) SmolLM for a few
hundred steps with the full substrate — the captured train step,
deterministic resumable data, async checkpointing — and show the loss
curve.

  python -m repro_torch.examples.train_smollm [--steps 300] [--device cpu]
"""
import argparse
import math
import tempfile

from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-config", action="store_true",
                    help="use the real 135M config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt:
        losses = train(
            "smollm-135m",
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            smoke=not args.full_config,
            ckpt_dir=ckpt,
            ckpt_every=100,
            device=args.device,
        )
    n = max(len(losses) // 10, 1)
    print("\nloss curve (decile means):")
    for i in range(0, len(losses), n):
        seg = losses[i : i + n]
        bar = "#" * int((seg[0] - min(losses)) * 40 / max(max(losses) - min(losses), 1e-6))
        print(f"  step {i:4d}  {sum(seg)/len(seg):.4f}  {bar}")
    print(f"\nfirst {losses[0]:.4f} -> last {losses[-1]:.4f}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: first "
                             f"{losses[0]}, last {losses[-1]}")
    return {"steps": args.steps, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses}


if __name__ == "__main__":
    main()
