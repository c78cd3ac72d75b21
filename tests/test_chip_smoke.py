"""CPU rehearsal of chip_smoke.py: its phases at tiny sizes with the
kernels in the interpreter, and its refusal to run without a GPU or
outside a checkout."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parity_phase_tiny():
    chip_smoke.phase_parity(w=128, h=64, n_random=40, max_tris=1500,
                            check_lowering=False, interpret=True)


def test_oracle_phase():
    chip_smoke.phase_oracle(interpret=True)


def test_timing_phase_tiny(capsys):
    chip_smoke.phase_timing(w=96, h=48, reps=1, interpret=True,
                            tiles=((16, 16),), frame_tiles=((16, 16),),
                            scene_frames=1)
    out = capsys.readouterr().out
    assert "Triton kernel" in out and "plain XLA" in out


def test_main_path_phase_tiny(capsys):
    chip_smoke.phase_main_path(w=128, h=64, frames=2, tri_frames=2,
                               compare_cpu=False)
    out = capsys.readouterr().out
    assert "bin_overflow 0" in out and "triangle demo" in out


def test_dispatch_phase(capsys):
    chip_smoke.phase_dispatch(n=5)
    assert "us/call" in capsys.readouterr().out


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    r = _run_script(str(lone), str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == "" or not r.stdout.strip().splitlines()[-1].startswith("{")


@pytest.mark.parametrize("argv", [["--bogus"], ["--help"]])
def test_cli_parses(argv):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code == (0 if argv == ["--help"] else 2)


def test_four_phase_on_virtual_cpu_devices(cpu_devices, capsys):
    """The --four path (sort-first, sort-last, auto vs one device, and the
    binary-swap composite) on 4 of the virtual CPU devices."""
    chip_smoke.phase_four(w=128, h=72, frames=1, platform="cpu")
    out = capsys.readouterr().out
    for mode in ("sort_first", "sort_last", "auto"):
        assert f"4 cards {mode}" in out
    assert "binary-swap composite" in out
