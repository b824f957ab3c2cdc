"""Python run framework — the counterpart of ``script/framework/pinc.py``:
a ``Pinc`` class that runs the simulator as a subprocess with
``section:key=value`` overrides and cleans the data directory between runs
(reference Pinc class, script/framework/pinc.py:20-52), or runs it in
process (``run_inproc``), which returns the energy history directly without
touching disk.

The run takes the CUDA card.  ``Pinc(..., device="cpu")`` runs on the CPU:
the child process then enters ``pinc_tpu_torch.__main__.main(argv,
device="cpu")``, since the CLI has no switch to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

REPO_ROOT = Path(__file__).resolve().parents[3]

#: the child of a CPU run: the CLI's main with device="cpu"
_CPU_CHILD = ("import sys; from pinc_tpu_torch.__main__ import main; "
              "raise SystemExit(main(sys.argv[1:], device='cpu'))")


class Pinc(dict):
    """dict of overrides; call run(ini) to execute."""

    def __init__(self, ini: str | Path, overrides: Optional[Dict] = None,
                 python: str = sys.executable, device=None):
        super().__init__(overrides or {})
        self.ini = str(ini)
        self.python = python
        self.device = device

    def _args(self):
        return [f"{k}={v}" for k, v in self.items()]

    def _cli(self):
        if self.device is None:
            return [self.python, "-m", "pinc_tpu_torch"]
        if str(self.device) != "cpu":
            raise ValueError(f"device {self.device!r}: a subprocess run "
                             "takes the card (device=None) or the CPU")
        return [self.python, "-c", _CPU_CHILD]

    def getnp(self) -> int:
        out = subprocess.run(
            self._cli() + [self.ini, "getnp"] + self._args(),
            capture_output=True, text=True, check=True,
            cwd=REPO_ROOT)
        return int(out.stdout.strip())

    def clean(self) -> None:
        """Remove the output data dir (reference Pinc.clean)."""
        prefix = self.get("files:output", "")
        if prefix:
            d = Path(prefix)
            d = d if prefix.endswith("/") else d.parent
            if d.exists() and d != Path("."):
                shutil.rmtree(d)

    def run(self, check: bool = True) -> subprocess.CompletedProcess:
        return subprocess.run(self._cli() + [self.ini] + self._args(),
                              check=check, cwd=REPO_ROOT)

    def run_inproc(self):
        """Run inside this process and return the history dict."""
        from ...config import PincConfig
        from ...parallel.pic import make_simulation
        cfg = PincConfig.from_file(self.ini, self._args())
        sim = make_simulation(cfg, device=self.device)
        return sim.run(progress_every=0)
