"""Logging — the equivalent of PINC's ``msg()``/``fMsg()``
(``src/io.c:170-248``); a copy of ``pinc_tpu/utils/logging.py`` for one
process (the port has no multi-process runs yet, so the rank is 0).

Message kinds STATUS/WARNING/ERROR/TIMER; ERROR raises (instead of the
reference's ``exit(EXIT_FAILURE)``).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, TextIO

STATUS, WARNING, ERROR, TIMER = "STATUS", "WARNING", "ERROR", "TIMER"

_t0 = time.monotonic()


def _proc_index() -> int:
    return 0


class PincError(RuntimeError):
    pass


def msg(kind: str, fmt: str, *args, all_ranks: bool = False) -> None:
    text = (fmt % args) if args else fmt
    rank = _proc_index()
    if kind == ERROR:
        raise PincError(text)
    if rank == 0 or all_ranks:
        tag = f"{kind}"
        if all_ranks:
            tag += f"(rank {rank})"
        print(f"[{tag} {time.monotonic()-_t0:8.2f}s] {text}", file=sys.stderr)


class MsgFiles:
    """``fMsg``: auxiliary log files named in the ``[msgfiles]`` ini section
    (src/io.c:219-248, 280-301)."""

    def __init__(self, cfg=None, output_dir: str | Path = "."):
        self._files: Dict[str, TextIO] = {}
        self._dir = Path(output_dir)
        if cfg is not None:
            for key in list(cfg.keys()):
                if key.startswith("msgfiles:"):
                    name = key.split(":", 1)[1]
                    path = self._dir / cfg.get_str(key)
                    path.parent.mkdir(parents=True, exist_ok=True)
                    self._files[name] = open(path, "w")

    def write(self, name: str, fmt: str, *args) -> None:
        f = self._files.get(name)
        if f is None:
            return
        f.write((fmt % args) if args else fmt)
        f.flush()

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
