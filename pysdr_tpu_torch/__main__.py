"""`python -m pysdr_tpu_torch`."""

import sys

from pysdr_tpu_torch.app import main

if __name__ == "__main__":
    sys.exit(main())
