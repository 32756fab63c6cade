"""Training launcher.

    python -m repro_torch.launch.train --arch qwen2-1.5b --full --steps 200 \
        --seq-len 512 --global-batch 8 --ckpt-dir /path/to/ckpt

A port of the JAX package's ``launch/train.py``, flag for flag.  It trains
on the card unless the caller of :func:`main` passes ``device="cpu"``;
without ``--full`` it trains the *reduced* config.  The data pipeline
feeds Bebop pages; restart picks up step + cursor from the latest
checkpoint automatically.
"""
import argparse
import sys


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--num-examples", type=int, default=2048)
    ap.add_argument("--full", action="store_true",
                    help="use the full architecture (on the card)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..configs import get_config, reduced_config
    from ..data import (BufferSource, DataConfig, Pipeline, synthetic_corpus,
                        write_example_pages)
    from ..train import OptimizerConfig, TrainConfig, Trainer
    from ..train.optimizer import leaves

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    tokens = synthetic_corpus(args.seq_len, args.num_examples,
                              cfg.vocab_size, seed=args.seed)
    buf = write_example_pages(args.seq_len, tokens, records_per_page=32)
    dc = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                    records_per_page=32)
    src = BufferSource(buf)
    pipe = Pipeline(dc, [src], len(src))

    trainer = Trainer(
        cfg,
        OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps,
                        compression=args.compression),
        TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, log_every=args.log_every,
                    seed=args.seed),
        data=iter(pipe), device=device or "cuda")
    n_params = sum(p.numel() for p in leaves(trainer.params))
    print(f"arch={cfg.name}  params≈{n_params / 1e6:.1f}M  "
          f"seq={args.seq_len} batch={args.global_batch}  "
          f"device={trainer.device}")
    result = trainer.run()
    pipe.stop()
    for m in trainer.metrics:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['tokens_per_s']:.0f} tok/s")
    print(f"finished: {result['status']} at step {result['step']}")
    return 0 if result["status"] in ("done", "preempted") else 1


if __name__ == "__main__":
    sys.exit(main())
