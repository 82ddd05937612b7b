"""The model zoo in PyTorch: every architecture as one decoder over a
parameter tree of nested dicts whose per-layer leaves are stacked on a
leading L axis (the JAX package's tree, so weights carry across through
``models/convert.py``)."""
