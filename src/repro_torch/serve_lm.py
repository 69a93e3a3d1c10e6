"""Batched LM serving example: prefill a prompt batch and decode new tokens
with the KV/state caches (every ``--arch``, rwkv6 and jamba included), as
the JAX package's ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.serve_lm                # on the card
    PYTHONPATH=src python -m repro_torch.serve_lm --device cpu [--arch rwkv6-7b]
"""
from __future__ import annotations

import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in args:
        args = ["--arch", "qwen3-1.7b"] + args
    return serve_main(args + ["--smoke", "--batch", "4", "--prompt-len",
                              "64", "--new-tokens", "32"])


if __name__ == "__main__":
    raise SystemExit(main())
