"""The port and its chip script stay lint-clean under tools/lint.py (the
repo's zero-dependency ruff subset), which does not list them by default."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("target", ["apsim_tpu_torch", "chip_smoke.py"])
def test_port_lint_clean(target):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "lint.py"),
         os.path.join(REPO, target)],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
