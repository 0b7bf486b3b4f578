"""The port's kernels: hand-written CUDA for the card, plain PyTorch for
the CPU. Model code calls ``repro_torch.kernels.ops``."""
