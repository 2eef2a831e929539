"""Train a small qwen3-family model on the synthetic LM stream.

Defaults are CPU-budget friendly (a ~3M-param model, 200 steps); pass
--d-model 768 --layers 12 --steps 300 for a ~100M-param run on the card.
It runs on the GPU unless ``--device cpu`` is given, and raises where
there is none:

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--steps 200] \
        [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the GPU by default; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = get_config("qwen3-0.6b").reduced(
        n_layers=args.layers, max_d_model=args.d_model, vocab=512)
    cfg = dataclasses.replace(base, n_layers=args.layers)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    tcfg = TrainConfig(
        steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_dir=args.ckpt_dir,
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=args.steps // 10,
                              total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      batch=args.batch)
    metrics = train(cfg, tcfg, dcfg, device=dev)
    print(f"\nfirst loss {metrics['first_loss']:.3f} -> "
          f"final loss {metrics['final_loss']:.3f} "
          f"(mean last-10: {metrics['mean_last10']:.3f})")
    assert metrics["final_loss"] < metrics["first_loss"]
    return metrics


if __name__ == "__main__":
    main()
