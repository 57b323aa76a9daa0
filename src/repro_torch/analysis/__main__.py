# The port's copy of repro/analysis/__main__.py: only the package prefix
# of its imports differs.
import sys

from .runner import main

sys.exit(main())
