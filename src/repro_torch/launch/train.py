"""Training launcher.

Runs any token-input architecture (full or ``--smoke`` reduced config)
with the training loop: microbatched gradient accumulation, optional
gradient compression, async checkpointing, and the fault-tolerance
control plane (heartbeats + an elastic restart drill with
``--simulate-failure``).  The model trains on ``--device`` (default: the
card).  ``--cache-dir`` (or ``REPRO_CACHE_DIR``) keeps the kernel build
across processes (``core/warmstart.py``).

    python -m repro_torch.launch.train --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import warmstart
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.fault import HeartbeatMonitor, elastic_plan
from repro_torch.training.grad_compress import CompressionConfig
from repro_torch.training.trainer import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk", "int8+topk"])
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--simulate-failure", action="store_true",
                    help="drill: drop a host mid-run, re-plan, restore")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent warm-start directory (the kernel "
                         "build); also via REPRO_CACHE_DIR")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    warm = warmstart.enable_warm_start(args.cache_dir)
    if warm["cache_dir"]:
        state = "on" if warm["compile_cache"] else "off"
        print(f"warm start: cache-dir {warm['cache_dir']} (kernel build "
              f"cache {state})", flush=True)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} trains on stub embeddings; use the "
                         "dry-run for its full-shape training cells")
    dev = resolve_device(args.device)

    tcfg = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 5),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       compression=CompressionConfig(args.compression),
                       ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, remat=not args.smoke)
    trainer = Trainer(cfg, tcfg, device=dev)
    if args.restore and trainer.restore_latest():
        print(f"restored step {trainer.step} from {args.ckpt_dir}")

    src = SyntheticLM(cfg.vocab, seed=0)

    def batches():
        step = trainer.step
        while True:
            yield to_device(src.batch(step, args.batch, args.seq), dev)
            step += 1

    if args.simulate_failure:
        half = args.steps // 2
        trainer.train(batches(), steps=half)
        trainer.ckpt.save(trainer.step, (trainer.params, trainer.opt))
        trainer.ckpt.wait()
        print("== simulating host failure ==")
        mon = HeartbeatMonitor(4, timeout_s=1.0, clock=lambda: 100.0)
        mon.hosts[2].last_beat = 0.0
        dead = mon.sweep()
        plan = elastic_plan(mon.alive_hosts, devices_per_host=1,
                            model_parallel=1,
                            global_batch=args.batch,
                            latest_ckpt=CKPT.latest_step(args.ckpt_dir))
        print(f"dead hosts {dead}; survivor plan: dp={plan.data_parallel}"
              f" batch-={plan.drop_batch} restore@{plan.restore_step}")
        # elastic restart: fresh trainer, restore, continue
        trainer = Trainer(cfg, tcfg, device=dev)
        assert trainer.restore_latest()
        print(f"restored at step {trainer.step}; continuing")
        trainer.train(batches(), steps=args.steps - half)
    else:
        trainer.train(batches(), steps=args.steps)

    final = trainer.history[-1]["loss"] if trainer.history else float("nan")
    print(f"done: step={trainer.step} final_loss={final:.4f}")


if __name__ == "__main__":
    main()
