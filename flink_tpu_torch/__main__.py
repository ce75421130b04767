"""``python -m flink_tpu_torch`` → the CLI frontend (cli.py)."""
import sys

from flink_tpu_torch.cli import main

sys.exit(main())
