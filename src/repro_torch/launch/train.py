"""Training launcher of the port: AdamW on the synthetic stream (or a byte
corpus) through the train-mode forward.  Weights are random, made from
``--seed``.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 50 \
        --batch 4 --seq-len 512 [--devices 4 --mesh-model 2] \
        [--ckpt-dir ckpts/]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --device cpu --steps 20 [--devices 8 --mesh-model 4]

It runs on the GPU unless ``--device cpu`` is given, and raises when no GPU
is present.  Gradients are taken on the plain ``"ref"`` attention, as the
reference takes them on ``"xla"``: neither package has a backward for its
attention kernel.  ``--devices N --mesh-model M`` (the reference's flags)
train over a ``(N / M, M)`` mesh of processes
(:class:`~repro_torch.training.train_loop.MeshTrainStep`): the batch rows
over ``data``, the model tensor-parallel over ``model``.  On the card every
process runs on the one GPU; with ``--device cpu`` on the CPU.  The
checkpoint is written whole, in the one-device format.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced (tiny, float32) variant of --arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data-vocab", type=int, default=64,
                    help="token support of the synthetic stream")
    ap.add_argument("--corpus", default=None,
                    help="byte-level corpus file (default: synthetic)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="processes of a (data, model) mesh (default: one "
                         "process, no mesh)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size when --devices is set")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      train)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = None
    if args.devices:
        if args.devices % args.mesh_model:
            raise ValueError(f"--mesh-model {args.mesh_model} does not "
                             f"divide --devices {args.devices}")
        mesh = Mesh(("data", "model"),
                    (args.devices // args.mesh_model, args.mesh_model))
    tcfg = TrainConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        grad_accum=args.grad_accum,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                              total_steps=args.steps))
    dcfg = DataConfig(vocab_size=min(args.data_vocab, cfg.vocab_size),
                      seq_len=args.seq_len, batch=args.batch,
                      seed=args.seed, corpus_path=args.corpus)
    metrics = train(cfg, tcfg, dcfg, mesh=mesh, device=args.device,
                    seed=args.seed)
    print(f"first loss {metrics['first_loss']:.4f} -> "
          f"final {metrics['final_loss']:.4f} "
          f"(mean last-10 {metrics['mean_last10']:.4f})")
    return metrics


if __name__ == "__main__":
    main()
