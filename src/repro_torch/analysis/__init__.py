# The port's copy of repro/analysis/__init__.py: only the package prefix
# of its imports differs.
"""repro_torch.analysis: custom static checks for the port's exec layer.

Three stdlib-`ast` checkers (no third-party deps), run over
src/repro_torch with a justified suppression baseline
(src/repro_torch/analysis/baseline.txt):

  locks    lock-discipline for classes annotated `# guarded-by:` —
           unguarded field access, callbacks invoked under a lock,
           blocking calls under a lock
  events   every EventLog.emit call site uses a declared protocol kind
           and passes its required fields (the static half of
           repro_torch.exec.protocol; validate_trace is the runtime
           half)
  api      no new imports of the deprecated realproc/runner_* shims;
           subprocess spawns paired with teardown

See `python -m repro_torch.analysis --help`.
"""
from . import api, common, events, locks  # noqa: F401
from .common import Finding, apply_baseline, load_baseline  # noqa: F401
from .runner import check_file, iter_py_files, run  # noqa: F401

__all__ = ["api", "common", "events", "locks", "Finding",
           "apply_baseline", "load_baseline", "check_file",
           "iter_py_files", "run"]
