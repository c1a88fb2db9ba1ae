"""``python -m pathway_tpu_torch`` runs the port's CLI (``cli.py``)."""

import sys

from pathway_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
