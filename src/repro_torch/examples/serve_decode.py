"""Batched serving example: prefill + greedy decode with a KV cache on any
of the 10 architectures (reduced configs), through the serve CLI's
``serve``.

  python -m repro_torch.examples.serve_decode --arch rwkv6-1.6b [--device cpu]
"""
import argparse

from repro_torch.configs import get_bundle
from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seq = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, smoke=True, device=args.device,
    )
    print("generated token ids (request 0):", seq[0].tolist())
    vocab = get_bundle(args.arch, smoke=True).cfg.vocab
    if tuple(seq.shape) != (args.batch, args.gen) or not bool(
            ((seq >= 0) & (seq < vocab)).all()):
        raise AssertionError(f"{args.arch}: token ids {tuple(seq.shape)} "
                             f"outside [0, {vocab})")
    return {"arch": args.arch, "tokens": seq.cpu(),
            "request0": seq[0].tolist()}


if __name__ == "__main__":
    main()
