"""chip_smoke.py refuses to report without a GPU, and its golden compare
counts every planted difference."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_golden_compare_reports_planted_mismatch():
    from chip_smoke import _golden_file, count_mismatches

    golden = _golden_file("p0")
    assert len(golden) == 305
    assert count_mismatches(list(golden), golden) == 0
    planted = list(golden)
    planted[123] = str(int(planted[123]) - 1)
    assert count_mismatches(planted, golden) == 1
    assert count_mismatches(golden[:-1], golden) == 1
