"""The latency of one gloo all-reduce among N processes on one machine, as
the tensor-parallel processes of ``repro_torch`` run it (one CPU thread a
process, a gloo group whose rendezvous is a file), in three ways:

- ``host``: a CPU tensor, all-reduced in place;
- ``staged``: a tensor on the card, as ``core/stage_procs.Comm`` runs it:
  ``torch.cuda.synchronize``, a copy into a pinned buffer, the
  all-reduce, a copy back to the card;
- ``staged-event``: the same, but waiting for the card on a blocking
  CUDA event (the host thread sleeps instead of spinning).

Each is timed on process 0's host clock over ``--iters`` calls after
``--warmup``, at each of ``--bytes`` (float32 operands), between two
small matrix products on the card (a layer's work between two sums).

    python3 scripts/gloo_allreduce_latency.py --procs 4

Prints one line a (mode, size): median, 10th and 90th percentile ms, and
the machine's CPU count.
"""
import argparse
import os
import statistics
import tempfile
import time
from datetime import timedelta


def _worker(rank, args, init_file, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=args.procs,
                            timeout=timedelta(seconds=120))
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda" if cuda else "cpu")
    w = torch.randn(1024, 1024, device=dev)
    results = {}
    for n_bytes in args.bytes:
        n = n_bytes // 4
        host = torch.ones(n)
        x = torch.ones(n, device=dev)
        pinned = torch.empty(n, pin_memory=cuda)
        event = torch.cuda.Event(blocking=True) if cuda else None

        def staged(wait):
            torch.mm(w, w)                             # the layer's work
            wait()
            pinned.copy_(x)
            dist.all_reduce(pinned)
            return pinned.to(dev, copy=True)

        def sync():
            torch.cuda.synchronize(dev)

        def on_event():
            event.record()
            event.synchronize()

        modes = {"host": lambda: dist.all_reduce(host)}
        if cuda:
            modes["staged"] = lambda: staged(sync)
            modes["staged-event"] = lambda: staged(on_event)
        for mode, fn in modes.items():
            times = []
            for i in range(args.warmup + args.iters):
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                if i >= args.warmup:
                    times.append((time.perf_counter() - t0) * 1e3)
            results[(mode, n_bytes)] = times
    if rank == 0:
        out.put(results)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--bytes", type=int, nargs="+",
                    default=[65536, 33554432])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    args = ap.parse_args()
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker,
                             args=(r, args, os.path.join(tmp, "rdv"), out))
                 for r in range(args.procs)]
        for p in procs:
            p.start()
        results = out.get(timeout=600)
        for p in procs:
            p.join(60)
    print(f"gloo all-reduce among {args.procs} processes, {os.cpu_count()} "
          f"CPUs")
    for (mode, n_bytes), t in results.items():
        q = statistics.quantiles(t, n=10)
        print(f"{mode} {n_bytes} bytes: median {statistics.median(t):.3f} "
              f"ms (p10 {q[0]:.3f}, p90 {q[-1]:.3f}) over {len(t)} calls")


if __name__ == "__main__":
    main()
