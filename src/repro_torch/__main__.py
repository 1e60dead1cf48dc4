"""``python -m repro_torch``: dispatch to the port's CLI (``repro_torch.cli``)."""
import sys

from repro_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
