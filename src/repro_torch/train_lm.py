"""End-to-end LM training example: a reduced-config model trained for 200
steps through the whole stack (MatRel data preprocessing, AdamW, grad
accumulation, async checkpoints, heartbeat/straggler monitoring), as the
JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.train_lm                # on the card
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu [--arch rwkv6-7b]

Any other flag of ``repro_torch.launch.train`` passes through; the
checkpoints go to ``repro_torch_ckpt`` under the temporary directory.
"""
from __future__ import annotations

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in args:
        args = ["--arch", "qwen3-1.7b"] + args
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    return train_main(args + ["--smoke", "--steps", "200", "--batch", "8",
                              "--seq", "128", "--ckpt-dir", ckpt,
                              "--log-every", "20"])


if __name__ == "__main__":
    raise SystemExit(main())
