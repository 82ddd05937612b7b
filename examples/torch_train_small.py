"""Train a small LM end-to-end with the production training stack.

The PyTorch port's version of ``examples/train_small.py``: reduced
granite-8b on synthetic data, microbatched grad accumulation, int8
gradient compression with error feedback, async checkpointing, and a
checkpoint/restart drill halfway through.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 120] \
        [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.training.grad_compress import CompressionConfig
from repro_torch.training.trainer import TrainConfig, Trainer

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = smoke_config(ARCHS["granite-8b"])
ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
tcfg = TrainConfig(lr=3e-3, warmup=10, total_steps=args.steps,
                   microbatches=2,
                   compression=CompressionConfig("int8"),
                   ckpt_every=args.steps // 2, ckpt_dir=ckpt_dir,
                   remat=False)
trainer = Trainer(cfg, tcfg, device=dev)
src = SyntheticLM(cfg.vocab, seed=0)


def batches(start):
    step = start
    while True:
        yield to_device(src.batch(step, 8, 64), dev)
        step += 1


half = args.steps // 2
hist = trainer.train(batches(0), steps=half, log_every=10)
trainer.ckpt.save(trainer.step, (trainer.params, trainer.opt))
trainer.ckpt.wait()

print(f"\n== checkpoint/restart drill at step {trainer.step} ==")
restarted = Trainer(cfg, tcfg, device=dev)
assert restarted.restore_latest(), "restore failed"
print(f"restored step {restarted.step}; continuing to {args.steps}")
hist = restarted.train(batches(restarted.step), steps=args.steps - half,
                       log_every=10)

first = sum(h["loss"] for h in trainer.history[:5]) / 5
last = sum(h["loss"] for h in restarted.history[-5:]) / 5
print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
      f"(ckpt dir {ckpt_dir})")
shutil.rmtree(ckpt_dir)
assert last < first, "loss did not improve"
