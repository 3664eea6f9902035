"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro/launch/train.py``: builds the model, optimizer and
pipeline of an architecture (full or ``--smoke``) on the plain attention
route (``attention_impl="reference"``, the route with a backward) and
drives the elastic fault-tolerant loop with asynchronous checkpoints, on
the card unless ``--device cpu`` is given (it never falls back to the
CPU).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

from ..configs import ARCH_IDS, arch_id, get_config, smoke_config
from ..training.data import DataConfig
from ..training.ft import ElasticTrainer, FTConfig
from ..training.optimizer import OptimizerConfig
from ..training.train import TrainConfig


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=arch_id, required=True,
                    help=f"one of {ARCH_IDS} (or its dashed form)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.scaled(attention_impl="reference")
    tc = TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps),
        accum_steps=args.accum, compress_grads=args.compress_grads)
    dc = DataConfig(batch_per_host=args.batch, seq_len=args.seq)
    ft = FTConfig(checkpoint_dir=args.ckpt_dir,
                  checkpoint_interval_steps=args.ckpt_interval)

    trainer = ElasticTrainer(cfg, tc, dc, ft, device=args.device)
    print(f"[train] arch={cfg.name} device={trainer.device} "
          f"attention_impl={cfg.attention_impl} steps={args.steps} "
          f"batch={args.batch}x{args.seq}")
    t0 = time.time()

    def log(ev):
        if ev.step % args.log_every == 0:
            tok_s = args.batch * args.seq / max(ev.duration_s, 1e-9)
            print(f"  step {ev.step:5d} loss {ev.loss:8.4f} "
                  f"{ev.duration_s*1e3:7.1f} ms/step {tok_s:9.0f} tok/s",
                  flush=True)

    events = trainer.run(args.steps, on_step=log)
    dt = time.time() - t0
    print(f"[train] done: {len(events)} steps in {dt:.1f}s; "
          f"final loss {events[-1].loss:.4f}")


if __name__ == "__main__":
    main()
