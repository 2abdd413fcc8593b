"""python -m readtape_tpu_torch <options> <base>: the port's command line,
on the card."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
