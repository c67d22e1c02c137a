import sys

from optimalinterpolation_tpu_torch.cli import main

sys.exit(main())
