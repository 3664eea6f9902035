"""Times the two forms of ``models.layers.dense``'s product on one card:
``x @ w`` (matmul folds the leading dimensions itself, ending in
``aten._unsafe_view``) and the fold made with views that a DTensor product
takes (``x.contiguous().view(-1, d) @ w``, viewed back, its gradient made
contiguous).

Three measurements, each in rounds A B B A (A the matmul, B the fold),
every module's ``dense`` swapped for the round:

* one call: the host wall of ``--calls`` calls (no gradient) at a decode
  projection's shape, ``--slots`` tokens of ``arch``'s width by its
  width, and at a tiny one (16 x 256 by 256, where the host's dispatch is
  all there is), ended by a sync;
* serving: ``arch`` at full width on the kernel route, ``--slots``
  prompts of 64-256 tokens and ``--decode-steps`` decode steps; the wall
  and the median decode step of each round, and whether the greedy tokens
  of the two forms agree;
* training: ``--train-arch`` at full width cut to ``--train-layers``
  layers (bf16, the plain attention, the default ``TrainConfig``,
  meshless), the median of its steps after the first.

Prints the card's ``nvidia-smi`` line and one JSON object.

    PYTHONPATH=src python scripts/dense_fold_ab.py --rounds 2
"""
import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params, layers, mla, moe, transformer
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import (DataConfig, ElasticTrainer, FTConfig,
                                  TrainConfig)


def matmul_dense(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def fold_dense(x, w, b=None):
    y = (x.contiguous().view(-1, x.shape[-1]) @ w).view(
        *x.shape[:-1], w.shape[-1])
    if y.requires_grad:
        y = layers._ContiguousGrad.apply(y)
    return y if b is None else y + b


FORMS = {"matmul": matmul_dense, "fold": fold_dense}
MODULES = (layers, mla, moe, transformer)


def use(form: str) -> None:
    for mod in MODULES:
        mod.dense = FORMS[form]


def call_round(form: str, x, w, calls: int) -> float:
    fn = FORMS[form]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(calls):
            fn(x, w)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def serve_round(cfg, model, prompts, steps: int, slots: int):
    eng = ServingEngine(cfg, model, n_slots=slots, max_len=1024,
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, pr in enumerate(prompts):
        eng.submit(Request(f"r{i}", pr, max_tokens=steps + 1,
                           arrival_s=eng.clock()))
    while eng.queue or eng.cache_mgr.active():
        eng.admit()
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, statistics.median(eng.metrics.step_times), [
        list(map(int, eng.requests[f"r{i}"].output))
        for i in range(len(prompts))]


def train_round(cfg, steps: int, ckpt_dir: str) -> float:
    tr = ElasticTrainer(cfg, TrainConfig(),
                        DataConfig(batch_per_host=4, seq_len=1024),
                        FTConfig(checkpoint_dir=ckpt_dir,
                                 checkpoint_interval_steps=10 ** 9),
                        device="cuda")
    tr.run(steps)
    med = statistics.median(e.duration_s for e in tr.events[1:])
    del tr
    torch.cuda.empty_cache()
    return med


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--train-arch", default="deepseek_7b")
    ap.add_argument("--train-layers", type=int, default=2)
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2,
                    help="A B B A blocks on each path")
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--ckpt-dir", default="build/dense_fold_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dense_fold_ab: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    order = ["matmul", "fold", "fold", "matmul"] * args.rounds
    out = {"torch": torch.__version__, "order": order}

    cfg = get_config(args.arch)
    g = torch.Generator(device="cuda").manual_seed(0)
    out["call_us"] = {}
    for label, (n, d) in (("decode", (args.slots, cfg.d_model)),
                          ("tiny", (16, 256))):
        x = torch.randn(n, 1, d, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(d, d, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        call_round("matmul", x, w, args.calls)  # warm
        us = {f: [] for f in FORMS}
        for form in order:
            us[form].append(call_round(form, x, w, args.calls))
        out["call_us"][label] = {
            "shape": [n, 1, d, d], "us": us,
            "fold_minus_matmul_us": statistics.median(us["fold"])
            - statistics.median(us["matmul"])}
    print("call " + json.dumps(out["call_us"]), flush=True)

    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(64, 257, args.slots)]
    use("matmul")
    serve_round(cfg, model, prompts, args.decode_steps, args.slots)  # warm
    walls, decode = {f: [] for f in FORMS}, {f: [] for f in FORMS}
    tokens = {}
    for form in order:
        use(form)
        wall, step, toks = serve_round(cfg, model, prompts,
                                       args.decode_steps, args.slots)
        walls[form].append(wall)
        decode[form].append(step)
        tokens.setdefault(form, toks)
    out["serve"] = {"arch": args.arch, "slots": args.slots,
                    "decode_steps": args.decode_steps, "wall_s": walls,
                    "decode_step_s_median": decode,
                    "tokens_equal": tokens["matmul"] == tokens["fold"],
                    "fold_over_matmul": statistics.median(walls["fold"])
                    / statistics.median(walls["matmul"]),
                    "decode_fold_over_matmul":
                    statistics.median(decode["fold"])
                    / statistics.median(decode["matmul"])}
    print("serve " + json.dumps(out["serve"]), flush=True)
    del model
    torch.cuda.empty_cache()

    tcfg = get_config(args.train_arch).scaled(n_layers=args.train_layers,
                                              attention_impl="reference")
    steps = {f: [] for f in FORMS}
    use("matmul")
    train_round(tcfg, 2, args.ckpt_dir)  # warm
    for form in order:
        use(form)
        steps[form].append(train_round(tcfg, args.train_steps,
                                       args.ckpt_dir))
    out["train"] = {"arch": args.train_arch, "layers": args.train_layers,
                    "step_s_median": steps,
                    "fold_over_matmul": statistics.median(steps["fold"])
                    / statistics.median(steps["matmul"])}
    use("matmul")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
