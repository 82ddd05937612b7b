"""LP5X-PIM Sim in PyTorch: the simulator's timing path with its lane
resolver as a hand-written CUDA kernel (``kernels/csrc/lane_scan.cu``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
