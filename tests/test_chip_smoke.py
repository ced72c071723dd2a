"""chip_smoke.py off the card: it refuses to run without a GPU or outside
the repository, and its phases rehearse on the CPU at tiny sizes."""

import os
import random
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    out = _run(REPO, SCRIPT)
    assert out.returncode != 0
    assert "needs a GPU; JAX found platform 'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    out = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke, chip_smoke.import_package()


def test_chip_smoke_exactness_phase(smoke, capsys):
    cs, ptpu = smoke
    key = ptpu.generate_keypair(256, enable_DJN=True)
    cs.phase_exactness(cs.engine_contexts(256, key), seed=1)
    assert "[exactness]" in capsys.readouterr().out


def test_chip_smoke_batches_phase(smoke, capsys):
    """CRT decrypt at several batch sizes, one of them padded (130 -> 256)."""
    cs, ptpu = smoke
    key = ptpu.generate_keypair(256, enable_DJN=True)
    cs.phase_batches(ptpu, key, (3, 130), seed=1, pool=4)
    assert "[batches] 256-bit CRT decrypt exact at batches [3, 130]: ok" in (
        capsys.readouterr().out
    )


def test_chip_smoke_four_phase(smoke, capsys):
    """The --four path on 4 of the 8 virtual CPU devices: sharded
    encrypt -> CT+CT -> CT*PT -> decrypt, bit-exact with one device."""
    cs, ptpu = smoke
    key = ptpu.generate_keypair(256, enable_DJN=True)
    times = {}
    cs.phase_four(ptpu, key, 16, 4, random.Random(2).getrandbits(16), times)
    assert "[four]" in capsys.readouterr().out
    assert set(times) == {"encrypt x4", "decrypt x4", "(CT+CT)*PT x4"}
