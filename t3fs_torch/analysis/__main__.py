"""``python -m t3fs_torch.analysis`` — run t3fslint over the tree."""

import sys

from t3fs_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
