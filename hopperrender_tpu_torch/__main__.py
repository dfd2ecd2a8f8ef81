"""python -m hopperrender_tpu_torch <command> ...: the command line (cli.py)."""

import sys

from hopperrender_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
