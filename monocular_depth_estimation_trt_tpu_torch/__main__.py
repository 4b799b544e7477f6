"""``python -m monocular_depth_estimation_trt_tpu_torch <command> ...`` (see ``cli.py``)."""

import sys

from monocular_depth_estimation_trt_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
