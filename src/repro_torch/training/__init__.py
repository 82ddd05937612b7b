"""Training: AdamW, gradient compression, checkpoints, fault hooks and
the trainer."""
