import sys

from flink_tpu_torch.lint.cli import main

sys.exit(main())
