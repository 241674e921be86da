"""The run's result: the last line of standard output, the numbers
compared on the last lines of standard error, and the guard against the
JAX package in the process."""

from __future__ import annotations

import json
import subprocess
import sys

# compared whole, before the first dot: repro_torch is not repro
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def emit(result: dict, checks: dict) -> None:
    """Print the checks on standard error, then the result line (its
    `checks` key last) on standard output."""
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps({**result, "checks": checks}), flush=True)
