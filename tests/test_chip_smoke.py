"""chip_smoke.py refuses to run without a GPU and without the repo."""

import os
import shutil
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone,why", [(False, "no GPU"),
                                       (True, "ModuleNotFoundError")])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone, why):
    script = os.path.join(_ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert why in proc.stderr
