"""Emulated-FaaS training driver (``repro.launch.emulate`` for the port): a
thin shim over ``python -m repro_torch emulate``.

    PYTHONPATH=src python -m repro_torch.launch.emulate --model bert-large --batch 64
    PYTHONPATH=src python -m repro_torch.launch.emulate --arch phi3-mini-3.8b \\
        --numerics --device cpu --stages 2 --dp 2 --batch 8 --seq 16 --steps 2
"""
from __future__ import annotations

import sys
from typing import List, Optional

from repro_torch.cli import main as _cli_main


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    # the driver's older spelling of the arch flag is --arch; both work
    args = ["--model" if a == "--arch"
            else "--model=" + a[len("--arch="):] if a.startswith("--arch=")
            else a
            for a in args]
    return _cli_main(["emulate", *args])


if __name__ == "__main__":
    sys.exit(main())
