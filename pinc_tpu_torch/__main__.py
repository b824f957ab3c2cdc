"""CLI entry point: ``python -m pinc_tpu_torch input.ini [getnp]
[section:key=value ...]``.

The interface of ``python -m pinc_tpu`` (the reference's ``iniOpen``,
src/io.c:254-311): a positional ini file, any number of
``section:key=value`` overrides, and ``getnp``, which prints the number of
subdomains the deck wants and exits.  The run mode comes from
``methods:mode`` (src/main.c:32-36).  The run takes the CUDA card when
there is one, else the CPU, and names the device in its first STATUS line.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from .config import PincConfig, required_np
from .registry import RUN_MODES
from .utils.logging import STATUS, msg


def main(argv=None, out: Optional[dict] = None) -> int:
    """Run the deck.  ``out``, when given, receives the run mode's result
    (for the regular mode: the energy histories, timings, drop counts and
    the simulation object under ``"sim"``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m pinc_tpu_torch <input.ini> [getnp] "
              "[section:key=value ...]", file=sys.stderr)
        return 2

    ini_path, args = argv[0], argv[1:]
    overrides = [a for a in args if a != "getnp"]
    cfg = PincConfig.from_file(ini_path, overrides)

    if "getnp" in args:
        print(required_np(cfg))
        return 0

    from . import simulation  # registry side effects

    # [msgfiles] parse dump (reference iniOpen, src/io.c:280-301): record
    # how the input was parsed, after CLI overrides
    if any(k.startswith("msgfiles:") for k in cfg.keys()):
        from .utils.logging import MsgFiles
        out_dir = cfg.get_str("files:output", "")
        mf = MsgFiles(cfg, output_dir=out_dir if out_dir.endswith("/")
                      else ".")
        for key in sorted(cfg.keys()):
            mf.write("parsedump", "%s = %s\n", key, cfg.get_str(key))
        mf.close()

    device = simulation.default_device()
    run = RUN_MODES.select(cfg, "methods:mode", default="regular")
    msg(STATUS, "PINC-TPU-torch started: %s on %s", ini_path,
        device if device.type == "cpu"
        else f"{device} ({torch.cuda.get_device_name(device)})")
    result = run(device=device)
    if out is not None:
        out.update(result)
    msg(STATUS, "PINC-TPU-torch finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
