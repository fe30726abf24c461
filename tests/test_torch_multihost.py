"""PyTorch port: ``parallel.initialize_multihost``, the twins of
``tests/test_multihost.py``.

Both branches run in one subprocess, one after the other (the default
process group is process-global, so it must not touch the test session):

- no cluster environment (no ``torchrun`` variables) → the single-process
  summary, with the reference's keys;
- explicit 1-process coordinator arguments → a real rendezvous over
  localhost (gloo, as the CPU asks).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_RUNNER = r"""
import json, sys
from opticalflowscivis_tpu_torch.parallel.multihost import initialize_multihost
# no cluster environment first, then the explicit coordinator in the same process
print("RESULT:" + json.dumps(initialize_multihost()))
print("RESULT:" + json.dumps(initialize_multihost(sys.argv[1], 1, 0, device="cpu", timeout_s=60)))
"""


@pytest.fixture(scope="module")
def results() -> list[dict]:
    """The two summaries, from one subprocess without torchrun's variables."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _RUNNER, f"127.0.0.1:{port}"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    found = [json.loads(line[len("RESULT:"):]) for line in out.stdout.splitlines()
             if line.startswith("RESULT:")]
    assert len(found) == 2, f"stdout={out.stdout}\nstderr={out.stderr}"
    return found


def test_single_process_fallback(results):
    info = results[0]
    assert info["initialized"] is False
    assert "torchrun" in info["reason"]
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["n_devices"] >= 1
    assert set(info) == {"initialized", "reason", "process_index", "process_count",
                         "n_devices"}


def test_explicit_one_process_coordinator(results):
    info = results[1]
    assert info["initialized"] is True
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["n_devices"] >= 1
