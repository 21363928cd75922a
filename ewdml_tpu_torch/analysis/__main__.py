"""``python -m ewdml_tpu_torch.analysis`` — same surface as the ``lint``
subcommand of ``ewdml_tpu_torch.cli``."""

import sys

from ewdml_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
