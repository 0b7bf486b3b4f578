"""Batched serving example of the PyTorch port: the paper's master
(batched action selection) as modern LLM inference — prefill a batch of
prompts, then decode. Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_batch_torch.py --arch mamba2-370m
    PYTHONPATH=src python examples/serve_batch_torch.py --arch qwen2-7b --gen 64
    PYTHONPATH=src python examples/serve_batch_torch.py --continuous --requests 8
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""
import sys

from repro_torch.launch.serve import main


def run(argv=None):
    """Forward to the serve launcher with ``--reduced`` defaulted on,
    without mutating ``sys.argv`` (importable and testable)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    return main(argv)


if __name__ == "__main__":
    run()
