"""End-to-end elastic training with failures, checkpoints and compression,
on the PyTorch port.

    PYTHONPATH=src python examples/train_elastic_torch.py --steps 300
    PYTHONPATH=src python examples/train_elastic_torch.py --device cpu

The port of ``examples/train_elastic.py``: trains a llama-style model
(deepseek-7b wiring, scaled) with the production loop: checkpoints every 25
steps, int8 error-feedback gradient compression, a failure injected
mid-run (restore + exact replay), and step-time telemetry. By default the
model is width-reduced; ``--big`` selects the ~100M config. The trainer
runs on the plain attention route (the route with a backward), so it
launches none of the port's kernels. Everything runs on ``--device``, the
card by default (it raises without one; pass ``--device cpu``).
"""
import argparse
import shutil
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import param_count
from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                  OptimizerConfig, TrainConfig)


def model_config(big: bool):
    base = get_config("deepseek_7b").scaled(attention_impl="reference")
    if big:   # ~100M params
        return base.scaled(n_layers=8, d_model=768, n_heads=12,
                           n_kv_heads=12, d_ff=2048, vocab_size=32_000,
                           max_seq_len=1024, dtype="float32")
    return base.scaled(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                       d_ff=704, vocab_size=8_192, max_seq_len=512,
                       dtype="float32")


def main(argv=None):
    """Trains, fails, restores and replays; returns the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (default: mid-run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = model_config(args.big)
    print(f"model: {param_count(cfg)/1e6:.1f}M params "
          f"({cfg.n_layers}L d{cfg.d_model})")

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        trainer = ElasticTrainer(
            cfg,
            TrainConfig(optimizer=OptimizerConfig(lr=6e-4, warmup_steps=20,
                                                  total_steps=args.steps),
                        compress_grads=True),
            DataConfig(batch_per_host=args.batch, seq_len=args.seq),
            FTConfig(checkpoint_dir=ckpt_dir, checkpoint_interval_steps=25),
            device=args.device)

        fail_at = args.fail_at if args.fail_at is not None \
            else args.steps // 2
        t0 = time.time()

        def log(ev):
            if ev.step % 20 == 0:
                tok_s = args.batch * args.seq / max(ev.duration_s, 1e-9)
                print(f"  step {ev.step:4d} loss {ev.loss:7.4f} "
                      f"{ev.duration_s*1e3:7.0f} ms {tok_s:8.0f} tok/s",
                      flush=True)

        trainer.run(fail_at, on_step=log)
        print(f">>> injecting failure at step {trainer.step} "
              f"(restores latest checkpoint, replays deterministically)")
        trainer.inject_failure()
        trainer.run(args.steps - fail_at, on_step=log)

        losses = [e.loss for e in trainer.events]
        print(f"done: {len(trainer.events)} step events "
              f"(incl. replays) in {time.time()-t0:.0f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return trainer


if __name__ == "__main__":
    main()
