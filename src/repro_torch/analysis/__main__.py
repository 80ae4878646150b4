"""Entry point: ``python -m repro_torch.analysis [paths]``."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
