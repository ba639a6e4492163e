"""Batched serving with the PyTorch port: prefill + greedy decode on a
reduced config.  The twin of ``examples/serve_batch.py``.

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cuda|cpu] [--arch phi4-mini-3.8b]

On the card the decode runs as one captured CUDA graph a step; on the CPU
through the eager step.
"""

import argparse
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    args = ap.parse_args(argv)
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", args.arch, "--smoke", "--batch", "4",
         "--prompt-len", "32", "--gen", "16", "--device", args.device],
        check=True,
    )


if __name__ == "__main__":
    main()
