# The port's copy of repro/core/apps.py: only the package prefix
# of its imports differs.
"""Application launch-cost profiles (paper §III-IV).

Each profile says what launching ONE instance costs:
  cpu_start      core-seconds of local exec/init work
  files_local    dependency files read when PREPOSITIONED on node-local disk
  files_central_warm   central-FS (Lustre) requests that remain even when
                       prepositioned — licenses, user code, homedir dotfiles;
                       this term is the Fig-6/7 hockey stick ("serving a few
                       files to each process ... does add up")
  files_central_cold   central-FS requests when NOT prepositioned (the full
                       dependency closure — "thousands of dependencies");
                       this term is the 30-60-minute naive launch.

Numbers are calibrated so the simulated launches land on the paper's own
headline results (see benchmarks/ and EXPERIMENTS.md §Validation).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AppProfile:
    name: str
    cpu_start: float            # core-seconds of init work
    files_local: int            # local-disk reads when prepositioned
    files_central_warm: float   # residual central-FS reads (prepositioned)
    files_central_cold: float   # central-FS reads when cold (full closure)


TENSORFLOW = AppProfile("tensorflow", cpu_start=1.0, files_local=400,
                        files_central_warm=1.5, files_central_cold=1200.0)
OCTAVE = AppProfile("octave", cpu_start=1.5, files_local=300,
                    files_central_warm=2.6, files_central_cold=900.0)
MATLAB = AppProfile("matlab", cpu_start=4.0, files_local=1500,
                    files_central_warm=3.0, files_central_cold=1500.0)
# §III: "MATLAB-lite ... loaded only the base toolboxes and did not include
# the internal Java invocation"
MATLAB_LITE = AppProfile("matlab-lite", cpu_start=1.2, files_local=500,
                         files_central_warm=2.5, files_central_cold=900.0)
PYTHON = AppProfile("python", cpu_start=0.3, files_local=150,
                    files_central_warm=1.0, files_central_cold=600.0)

PROFILES = {p.name: p for p in
            (TENSORFLOW, OCTAVE, MATLAB, MATLAB_LITE, PYTHON)}
