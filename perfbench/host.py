"""What a run reads of the host and the card besides its metrics, and its
log on standard error."""

from __future__ import annotations

import subprocess
import sys

CARD_STATE = "clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"


def smi(device, fields: str) -> str:
    """`nvidia-smi --query-gpu=<fields>` of the card, or "not measured"."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
