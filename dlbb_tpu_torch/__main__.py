"""``python -m dlbb_tpu_torch`` — same CLI as ``python -m dlbb_tpu_torch.cli``."""

import sys

from dlbb_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
