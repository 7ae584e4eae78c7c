"""The port's examples (``repro_torch.examples``) run end to end on the CPU.

Each example asserts its own answers (quickstart and dynamic_graph against
the brute-force oracle, serve_tcq each batch against its requests run
alone in serial mode), so exit code 0 and the line that reports the check
together show it held.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name,args,says", [
    ("quickstart", (), "serial, wave and iPHC match the brute-force oracle"),
    ("dynamic_graph", (), "equal to the oracle"),
    ("serve_tcq", ("--requests", "2"), "served 2 requests on cpu, each "
                                       "equal to its serial run"),
])
def test_example_runs_on_cpu(name, args, says):
    out = _run(name, "--device", "cpu", *args)
    assert out.returncode == 0, out.stderr
    assert says in out.stdout, out.stdout


def test_example_defaults_to_cuda():
    out = _run("quickstart")
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
        assert "on cuda" in out.stdout
    else:
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
